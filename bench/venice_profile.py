"""Phase-level profile of the Venice-scale component-major Schur iteration.

Times each jitted phase of solver/schur_large.py's LM step separately
(compile excluded: every phase runs once untimed first), so optimization
effort lands on the measured-dominant phase instead of a guess.

Usage (on the GPU, one process on the card):
    python bench/venice_profile.py [--cams 1700 --pts 1000000 --obs 5
                                    --chunks 128 --cg 20 --repeat 3]

Writes a phase table to stdout; the per-LM-iteration model is
    grad_linearize + prepare + pcg_init + cg_per_it*CG + backsub + cost_linearize
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=1700)
    ap.add_argument("--pts", type=int, default=1000000)
    ap.add_argument("--obs", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=128)
    ap.add_argument("--cg", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--dual", action="store_true",
                    help="dual-order W: landmark-direction cumsum matvec")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver.schur_large import (
        _backsub_retract,
        _linearize_stream,
        _pcg_init,
        _pcg_segment,
        _schur_prepare,
        prepare_large_ba,
    )

    t0 = time.perf_counter()
    data = synth.ba_synthetic(
        n_cams=args.cams, n_pts=args.pts, obs_per_pt=args.obs, seed=0
    )
    g = build.ba_graph(data)
    lb = prepare_large_ba(g, args.chunks)
    print(
        f"setup {time.perf_counter()-t0:.1f}s: C={lb.C} L={lb.L} Mp={lb.Mp} "
        f"chunks={lb.n_chunks} device={jax.devices()[0].platform}"
    )
    dtype = jnp.asarray(lb.poses).dtype
    lam = jnp.asarray(1e-4, dtype)
    PP = jnp.zeros((0, 6, 6), dtype)
    pi = jnp.zeros(0, jnp.int32)
    pj = jnp.zeros(0, jnp.int32)

    timings = {}

    def bench(name, fn):
        out = fn()  # compile + correctness of shapes
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        timings[name] = best
        print(f"{name:24s} {best*1000:9.1f} ms")
        return out

    chi2, Hpp, g_p, Hll, g_l, W = bench(
        "linearize_grad",
        lambda: _linearize_stream(
            lb.kind, lb.loss, lb.n_chunks, lb.C, lb.L, True, lb.trails,
            lb.poses, lb.lms, lb.obs_data, lb.ci, lb.li, lb.w_pad, lb.cam_starts,
            lb.lorder, lb.lm_starts,
        ),
    )

    bench(
        "linearize_cost",
        lambda: _linearize_stream(
            lb.kind, lb.loss, lb.n_chunks, lb.C, lb.L, False, lb.trails,
            lb.poses, lb.lms, lb.obs_data, lb.ci, lb.li, lb.w_pad, lb.cam_starts,
        ),
    )

    prep = bench(
        "schur_prepare",
        lambda: _schur_prepare(
            "lm", lb.C, lb.L, Hpp, g_p, Hll, g_l, W, PP,
            lb.free_p, lb.free_l, lb.ci, lb.li, pi, pj, lb.cam_starts, lam,
            lorder=lb.lorder, dual=args.dual,
        ),
    )
    Hpp_d, Hinv, W_m, PP_m, g_l_m, g_red, Dinv, live, W_l, _D = prep
    ci_l, lm_starts = (lb.ci_l, lb.lm_starts) if args.dual else (None, None)
    if not args.dual:
        W_l = None

    state, r0 = bench(
        "pcg_init",
        lambda: _pcg_init(
            lb.C, lb.L, Hpp_d, Hinv, W_m, PP_m, lb.ci, lb.li, pi, pj,
            lb.cam_starts, Dinv, g_red.reshape(-1),
        ),
    )

    bench(
        f"pcg_segment_{args.cg}",
        lambda: _pcg_segment(
            lb.C, lb.L, args.cg, Hpp_d, Hinv, W_m, PP_m, lb.ci, lb.li, pi, pj,
            lb.cam_starts, Dinv, state, W_l, ci_l, lm_starts,
        ),
    )
    timings["cg_per_it"] = timings[f"pcg_segment_{args.cg}"] / args.cg
    print(f"{'cg_per_it':24s} {timings['cg_per_it']*1000:9.1f} ms")

    bench(
        "backsub_retract",
        lambda: _backsub_retract(
            lb.C, lb.L, Hpp_d, Hinv, W_m, lb.ci, lb.li, lb.cam_starts,
            g_l_m, live, lb.free_p, lb.poses, lb.lms, state[0],
            W_l, ci_l, lm_starts,
        ),
    )

    per_it = (
        timings["linearize_grad"]
        + timings["linearize_cost"]
        + timings["schur_prepare"]
        + timings["pcg_init"]
        + timings[f"pcg_segment_{args.cg}"]
        + timings["backsub_retract"]
    )
    print(f"\nmodelled s/it @ {args.cg} CG its: {per_it:.2f} s")


if __name__ == "__main__":
    main()
