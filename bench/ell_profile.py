"""Plain-XLA timings of the ELL hot ops at sphere2500 widths.

    python bench/ell_profile.py [--poses 2500]

Times, on the GPU, what XLA makes of the plain versions of the two ops the
pose-graph path spends its iterations in:

  * the symmetric-ELL matvec (``bcsr.ell_direct_matvec``): per jitted call,
    and per application inside one compiled loop of dependent matvecs (trip
    count a runtime value, as in CG, or a compile-time constant);
  * one CG iteration inside ``solve_ell`` (two single-LM-iteration solves
    with a fixed CG count, differenced);
  * the direct-to-ELL assembly ``assemble_ell`` (linearize + scatter-add),
    per jitted call.

Prints one JSON line with the times in microseconds, the bytes the matvec
must move and its floor at the H100's published 3.35 TB/s.  Exits non-zero
without a GPU unless JAX_PLATFORMS=cpu is set.
"""

from __future__ import annotations

import argparse
import json
from functools import partial
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


def _median_us(fn, repeat):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=2500)
    ap.add_argument("--repeat", type=int, default=200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from device import device_fields, require_gpu
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options
    from pyslam_tpu.solver.bcsr import (
        assemble_ell,
        build_ell_direct,
        ell_direct_matvec,
        solve_ell,
    )
    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    require_gpu()

    g = build.pose_graph(synth.se3_sphere(n_poses=args.poses, seed=0), dtype=jnp.float32)
    plan = build_ell_direct(g)
    nb, K, d = plan.nb, plan.K, plan.d
    cols = jnp.asarray(plan.cols)

    asm = jax.jit(lambda gr: assemble_ell(gr, plan))
    assemble_us = _median_us(lambda: asm(g), args.repeat)
    He, _, _ = asm(g)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(nb * d), jnp.float32)

    mv = jax.jit(ell_direct_matvec)
    matvec_call_us = _median_us(lambda: mv(He, cols, x), args.repeat)

    def per_matvec_us(static_n):
        @partial(jax.jit, static_argnums=(2,) if static_n else ())
        def chain(He, x, n):
            # n dependent matvecs in one program; the bounded map keeps
            # values finite and fuses into the contraction's epilogue
            def body(_, v):
                y = ell_direct_matvec(He, cols, v)
                return y / (1.0 + jnp.abs(y))

            return jax.lax.fori_loop(0, n, body, x)

        n_lo, n_hi = 100, 1100
        t_lo = _median_us(lambda: chain(He, x, n_lo), 20)
        t_hi = _median_us(lambda: chain(He, x, n_hi), 20)
        return (t_hi - t_lo) / (n_hi - n_lo)

    matvec_loop_us = per_matvec_us(static_n=False)
    # the same loop with its trip count known at compile time: the
    # difference is what the loop's per-iteration predicate costs
    matvec_static_loop_us = per_matvec_us(static_n=True)

    one_it = Options(method="lm", max_iters=1)
    cg_lo, cg_hi = 10, 110
    s_lo = _median_us(
        lambda: solve_ell(g, one_it, plan=plan, pcg_rtol=0.0, pcg_max_iters=cg_lo), 20
    )
    s_hi = _median_us(
        lambda: solve_ell(g, one_it, plan=plan, pcg_rtol=0.0, pcg_max_iters=cg_hi), 20
    )
    cg_iter_us = (s_hi - s_lo) / (cg_hi - cg_lo)

    # bytes one matvec must move: the blocks, the gathered x rows, y
    matvec_bytes = 4 * (nb * K * d * d + nb * K * d + nb * d)
    print(json.dumps({
        "nb": nb, "K": K, "d": d,
        "assemble_ell_us": assemble_us,
        "matvec_call_us": matvec_call_us,
        "matvec_in_loop_us": matvec_loop_us,
        "matvec_in_static_loop_us": matvec_static_loop_us,
        "solve_ell_cg_iter_us": cg_iter_us,
        "single_lm_iter_solve_us": {str(cg_lo): s_lo, str(cg_hi): s_hi},
        "matvec_bytes": matvec_bytes,
        "matvec_floor_us_at_3.35TBps": matvec_bytes / HBM_BYTES_PER_S * 1e6,
        **device_fields(),
    }))


if __name__ == "__main__":
    main()
