"""Preconditioner / exact-solver sweep at large pose-graph scale
(VERDICT r2 next #10): block-Jacobi PCG vs the two-level coarse-grid
preconditioner vs group block-Jacobi vs the multifrontal sparse direct
path, all solving the same graph to the same convergence contract.

    python bench/sweep_precond.py [--poses 50000] [--which bj,two_level,...]

Appends one JSON line per variant to bench/results.jsonl
(config "precond_sweep_<n>").
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
    ap.add_argument("--poses", type=int, default=50000)
    ap.add_argument("--which", default="bj,two_level,group,sparse_chol")
    ap.add_argument("--max-iters", type=int, default=25)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl"))
    args = ap.parse_args()

    import jax

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options
    from pyslam_tpu.solver.bcsr import build_ell_direct, solve_bcsr, solve_ell

    data = synth.se3_sphere(n_poses=args.poses, seed=0)
    g = build.pose_graph(data)
    plan = build_ell_direct(g)
    opts = Options(method="lm", max_iters=args.max_iters)

    def timed(run):
        s, info = run()  # compile + converge
        jax.block_until_ready(s.blocks["poses"].values)
        t0 = time.perf_counter()
        s, info = run()
        jax.block_until_ready(s.blocks["poses"].values)
        return info, time.perf_counter() - t0

    variants = {
        "bj": lambda: solve_ell(g, opts, plan=plan),
        "two_level": lambda: solve_ell(g, opts, plan=plan, precond="two_level", coarse_size=256),
        "group": lambda: solve_bcsr(g, opts, pcg_rtol=1e-8, pcg_max_iters=min(1000, max(120, plan.nb // 80)), precond_group=8),
    }

    def run_sparse():
        from pyslam_tpu.solver.sparse_chol import build_chol_plan, solve_sparse_chol

        cplan = build_chol_plan(g, leaf_size=48)
        pool_gb = cplan.pool_total * 36 * 4 / 1e9  # 36 f32 per 6x6 block
        print(f"sparse_chol plan: {len(cplan.waves)} waves, pool {pool_gb:.2f} GB", flush=True)
        if pool_gb > 6.0:
            return None, dict(skipped=f"update pool {pool_gb:.1f} GB exceeds HBM budget")
        return lambda: solve_sparse_chol(g, opts, plan=cplan), {}

    for name in args.which.split(","):
        rec = dict(config=f"precond_sweep_{args.poses}", variant=name)
        try:
            if name == "sparse_chol":
                run, extra = run_sparse()
                rec.update(extra)
                if run is None:
                    print(json.dumps(rec), flush=True)
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                    continue
            else:
                run = variants[name]
            info, wall = timed(run)
            rec.update(
                wall_s=wall,
                iters=int(info.iterations),
                chi2=float(info.chi2),
                s_per_it=wall / max(int(info.iterations), 1),
            )
        except Exception as e:  # record the failure, keep sweeping
            rec.update(error=f"{type(e).__name__}: {e}"[:300])
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
