"""One-time converged f64 reference optimum for bench config 5
(venice-mini, 300 cams / 60k landmarks / 360k obs) — VERDICT r4 #2a.

Solves the exact same synthetic problem with the OTHER linear solver
family (dense-S direct Cholesky, solver/schur_large linear="dense") in
f64 to convergence, and writes the converged chi2 into
bench/standin_cache.json under "venice_mini_ref".  bench/run.py config_5
gates the device run's chi2 within 0.1% of this optimum, the same standard
as configs 1-4.

Runs on the CPU backend (f64, and it leaves the GPU to the process that
measures), forced via in-process config BEFORE the backend initializes:
    python scripts/venice_mini_ref.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from pyslam_tpu.graph import build
from pyslam_tpu.io import synth
from pyslam_tpu.solver import Options
from pyslam_tpu.solver.schur_large import solve_schur_large

CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bench", "standin_cache.json",
)


def main():
    data = synth.ba_synthetic(n_cams=300, n_pts=60000, obs_per_pt=6, seed=0)
    g = build.ba_graph(data, dtype=jnp.float64)
    t0 = time.time()
    _, chi2, hist = solve_schur_large(
        g,
        Options(method="lm", max_iters=60, min_cost_decrease=1.0 - 1e-9),
        n_chunks=16,
        linear="dense",
    )
    wall = time.time() - t0
    print(f"converged chi2 = {chi2:.6f} in {len(hist) - 1} iters, {wall:.1f} s")
    print("history tail:", [float(h) for h in hist[-5:]])
    with open(CACHE) as f:
        c = json.load(f)
    c["venice_mini_ref"] = {
        "chi2": float(chi2),
        "iters": len(hist) - 1,
        "wall_s": wall,
        "label": "f64 dense-S direct LM to convergence (schur_large linear=dense, CPU)",
    }
    with open(CACHE, "w") as f:
        json.dump(c, f)
    print("cached under venice_mini_ref")


if __name__ == "__main__":
    main()
