"""Venice-scale linear-solver shootout: PCG vs dense-S direct Cholesky.

Measures solve_schur_large with linear="pcg" (the default path) against linear="dense" (exact reduced-camera-system
factorization from host-enumerated co-observation pairs,
solver/schur_large._dense_solve_fused) on the same prebuilt plan.

Protocol matches bench/run.py config_6 for the timed solve: one warmup LM
iteration absorbs compile, then a timed steady-state
solve; chi2 must beat the ground-truth chi2 (same gate).  One deliberate
difference from config_6: the plan build (prepare_large_ba) is timed
SEPARATELY and recorded as plan_build_s, whereas config_6 folds it into
warmup_s — do not cross-compare warmup_s between the two row kinds.
Appends one JSON row per solver to bench/results.jsonl with --record.

Usage:
    python bench/venice_dense.py --n-cams 400 --n-pts 200000   # probe
    python bench/venice_dense.py                               # full Venice
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-cams", type=int, default=1700)
    ap.add_argument("--n-pts", type=int, default=1000000)
    ap.add_argument("--obs-per-pt", type=int, default=5)
    ap.add_argument(
        "--linear", default="both",
        choices=["both", "pcg", "dense", "cluster64", "cluster128", "stale",
                 "all"],
    )
    ap.add_argument("--pair-chunks", type=int, default=4)
    ap.add_argument("--n-chunks", type=int, default=128)
    ap.add_argument("--max-iters", type=int, default=10)
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args()

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options
    from pyslam_tpu.solver.schur_large import (
        _linearize_stream,
        prepare_large_ba,
        solve_schur_large,
    )

    t0 = time.perf_counter()
    data = synth.ba_synthetic(
        n_cams=args.n_cams, n_pts=args.n_pts, obs_per_pt=args.obs_per_pt, seed=0
    )
    g = build.ba_graph(data)
    plan = prepare_large_ba(g, args.n_chunks)
    plan_build_s = time.perf_counter() - t0
    print(f"# graph+plan build: {plan_build_s:.1f} s", flush=True)

    lb = prepare_large_ba(build.ba_graph(data, init="gt"), args.n_chunks)
    chi2_gt = float(
        _linearize_stream(
            lb.kind, lb.loss, args.n_chunks, lb.C, lb.L, False, lb.trails,
            lb.poses, lb.lms, lb.obs_data, lb.ci, lb.li, lb.w_pad,
        )
    )
    del lb
    print(f"# chi2_gt = {chi2_gt:.4g}", flush=True)

    rows = []
    variants = (
        ["pcg", "dense"] if args.linear == "both"
        else ["pcg", "dense", "stale", "cluster64", "cluster128"]
        if args.linear == "all"
        else [args.linear]
    )
    for name in variants:
        common = dict(n_chunks=args.n_chunks, plan=plan)
        if name == "pcg":
            common.update(pcg_rtol=1e-4, pcg_max_iters=20)
        elif name == "stale":
            common.update(
                pcg_rtol=1e-4, pcg_max_iters=20,
                precond="stale", stale_refresh=3,
                n_pair_chunks=args.pair_chunks,
            )
        elif name.startswith("cluster"):
            common.update(
                pcg_rtol=1e-4, pcg_max_iters=20,
                precond="cluster", cluster_size=int(name.removeprefix("cluster")),
                n_pair_chunks=args.pair_chunks,
            )
        else:
            common.update(linear="dense", n_pair_chunks=args.pair_chunks)
        t0 = time.perf_counter()
        solve_schur_large(g, Options(method="lm", max_iters=1), **common)
        warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, chi2, hist = solve_schur_large(
            g, Options(method="lm", max_iters=args.max_iters), **common
        )
        wall = time.perf_counter() - t0
        iters = len(hist) - 1
        row = dict(
            config=f"venice_dense_compare/{name}",
            n_cams=args.n_cams, n_pts=args.n_pts, obs=int(plan.M),
            wall_s=round(wall, 3), warmup_s=round(warmup_s, 3),
            plan_build_s=round(plan_build_s, 3), iters=iters,
            s_per_it=round(wall / max(iters, 1), 4),
            chi2=chi2, chi2_gt=chi2_gt, parity=bool(chi2 <= chi2_gt),
            hist=[float(h) for h in hist],
            device=__import__("jax").default_backend(),
        )
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.record:
        with open(os.path.join(os.path.dirname(__file__), "results.jsonl"), "a") as f:
            for row in rows:
                row = dict(row)
                row.pop("hist", None)
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
