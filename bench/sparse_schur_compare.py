"""SPARSE_SCHUR vs ITERATIVE_SCHUR wall-clock on the same graph.

Compares the two beyond-dense-ceiling Schur paths on a many-poses /
few-landmarks graph (the regime route_auto gates to schur_sparse):

  * solve_schur_sparse — exact multifrontal factorization of S
  * solve_schur(mode='pcg') — SCHUR_JACOBI-preconditioned PCG

Run on the GPU (CPU numbers are architecture smoke only):  python bench/sparse_schur_compare.py [--poses 2000]

Prints one JSON line per path: wall (steady-state, after a compile run),
iterations, chi2; plus the plan-build host time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=2000)
    ap.add_argument("--landmarks", type=int, default=300)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--pcg-rtol", type=float, default=1e-8)
    ap.add_argument("--pcg-max-iters", type=int, default=400)
    args = ap.parse_args()

    import jax

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, solve_schur
    from pyslam_tpu.solver.schur_sparse import build_schur_sparse_plan, solve_schur_sparse

    data = synth.landmark_slam_2d(
        n_poses=args.poses, n_landmarks=args.landmarks, max_range=10.0,
        odo_rot_std=0.005, seed=0,
    )
    g = build.landmark_slam_2d(data)
    opts = Options(method="lm", max_iters=args.iters)

    t0 = time.perf_counter()
    plan = build_schur_sparse_plan(g)
    t_plan = time.perf_counter() - t0

    def timed(run):
        run()  # compile
        t = time.perf_counter()
        info = run()
        return info, time.perf_counter() - t

    def run_sparse():
        s, info = solve_schur_sparse(g, opts, plan=plan)
        jax.block_until_ready(s.blocks["poses"].values)
        return info

    def run_pcg():
        s, info = solve_schur(
            g, opts, mode="pcg", pcg_rtol=args.pcg_rtol,
            pcg_max_iters=args.pcg_max_iters,
        )
        jax.block_until_ready(s.blocks["poses"].values)
        return info

    i_sp, w_sp = timed(run_sparse)
    i_pcg, w_pcg = timed(run_pcg)
    print(json.dumps(dict(
        path="schur_sparse", wall_s=round(w_sp, 3), iters=int(i_sp.iterations),
        chi2=float(i_sp.chi2), plan_build_s=round(t_plan, 3),
        pairs=plan.n_pairs, s_edges=plan.n_edges,
    )))
    print(json.dumps(dict(
        path="schur_pcg", wall_s=round(w_pcg, 3), iters=int(i_pcg.iterations),
        chi2=float(i_pcg.chi2), pcg_rtol=args.pcg_rtol,
    )))


if __name__ == "__main__":
    main()
