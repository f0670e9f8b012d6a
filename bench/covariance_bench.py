"""Covariance-path timings: Takahashi selected inversion vs column solves.

Run on the GPU (CPU numbers are architecture smoke):  python bench/covariance_bench.py [--poses 3500]

Prints one JSON line per method: all-marginals selected inversion
(factor once + one top-down sweep), a 16-variable column-solve subset
(the pre-selinv approach, extrapolated per-variable), and the shared
factorization cost.
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
    ap.add_argument("--poses", type=int, default=3500)
    args = ap.parse_args()

    import jax

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, solve_auto
    from pyslam_tpu.solver.bcsr import assemble_ell
    from pyslam_tpu.solver.covariance import marginal_covariances_direct
    from pyslam_tpu.solver.sparse_chol import _factorize, build_chol_plan

    data = synth.se2_manhattan(n_poses=args.poses, seed=1)
    g = build.pose_graph(data)
    solved, _ = solve_auto(g, Options(method="gn", max_iters=25))

    t0 = time.perf_counter()
    plan = build_chol_plan(solved)
    t_plan = time.perf_counter() - t0
    He, _, _ = assemble_ell(solved, plan.ell)
    t0 = time.perf_counter()
    factors = jax.block_until_ready(_factorize(plan, He))
    t_factor_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    factors = jax.block_until_ready(_factorize(plan, He))
    t_factor = time.perf_counter() - t0

    def timed(fn):
        jax.block_until_ready(fn())  # compile
        t = time.perf_counter()
        jax.block_until_ready(fn())
        return time.perf_counter() - t

    w_all = timed(lambda: marginal_covariances_direct(solved, plan=plan, factors=factors))
    idx = np.linspace(0, args.poses - 1, 16).astype(int)
    w_16 = timed(
        lambda: marginal_covariances_direct(solved, plan=plan, factors=factors, indices=idx)
    )
    print(json.dumps(dict(
        poses=args.poses, plan_build_s=round(t_plan, 2),
        factorize_warm_s=round(t_factor, 4), factorize_cold_s=round(t_factor_cold, 2),
    )))
    print(json.dumps(dict(
        method="selinv_all_marginals", wall_s=round(w_all, 4),
        per_variable_us=round(1e6 * w_all / args.poses, 2),
    )))
    print(json.dumps(dict(
        method="column_solves_16", wall_s=round(w_16, 4),
        per_variable_us=round(1e6 * w_16 / 16, 2),
        extrapolated_all_s=round(w_16 / 16 * args.poses, 2),
    )))


if __name__ == "__main__":
    main()
