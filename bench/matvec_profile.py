"""Micro-profile of the Venice S-matvec's internal ops (schur_large).

The phase profile (bench/venice_profile.py) shows the segmented PCG is
~80% of the Venice iteration at ~480 ms per CG step; this script times the
matvec's constituent XLA ops in isolation so the optimization lands on the
measured-dominant one (scatter vs gather vs cumsum vs elementwise).

Run alone on the GPU: python bench/matvec_profile.py
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
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()

    C, L = args.cams, args.pts
    Mp = args.pts * args.obs
    rng = np.random.default_rng(0)
    # index structure mirrors prepare_large_ba: camera-sorted ci, random li
    ci = np.sort(rng.integers(0, C, Mp)).astype(np.int32)
    li = rng.integers(0, L, Mp).astype(np.int32)
    lorder = np.argsort(li, kind="stable").astype(np.int32)
    ci_l = ci[lorder]
    cam_starts = np.searchsorted(ci, np.arange(C + 1)).astype(np.int32)
    lm_starts = np.searchsorted(li[lorder], np.arange(L + 1)).astype(np.int32)

    W = jnp.asarray(rng.standard_normal((18, Mp)), jnp.float32)
    W_l = jnp.asarray(np.asarray(W)[:, lorder])
    xb = jnp.asarray(rng.standard_normal((C, 6)), jnp.float32)
    t3 = jnp.asarray(rng.standard_normal((3, L)), jnp.float32)
    d_ci = jnp.asarray(ci)
    d_li = jnp.asarray(li)
    d_ci_l = jnp.asarray(ci_l)
    d_cs = jnp.asarray(cam_starts)
    d_ls = jnp.asarray(lm_starts)
    d_lorder = jnp.asarray(lorder)
    acc = jnp.asarray(rng.standard_normal(Mp), jnp.float32)

    def bench(name, fn):
        out = fn()
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        print(f"{name:36s} {best*1000:9.2f} ms")
        return out

    print(f"Mp={Mp} C={C} L={L} device={jax.devices()[0].platform}")

    # --- single ops (arrays passed as ARGUMENTS: closed-over device
    # arrays are embedded as HLO constants and shipped in the compile
    # request — a 360MB W overflows the remote-compile service, and even
    # small constants skew timing; CLAUDE.md "NEVER jnp.asarray inside a
    # traced function" is the same trap) ---
    j_gather = jax.jit(lambda src_, idx: src_[idx])
    bench("gather xb[:,0][ci]  (small src)", lambda: j_gather(xb[:, 0], d_ci))
    bench("gather t3[0][li]    (4MB src)", lambda: j_gather(t3[0], d_li))
    bench("gather W[0][lorder] (19MB src)", lambda: j_gather(W[0], d_lorder))

    j_seg = jax.jit(lambda a, idx, n: jax.ops.segment_sum(a, idx, num_segments=n),
                    static_argnums=2)
    bench("segment_sum -> L=1M", lambda: j_seg(acc, d_li, L))
    bench("segment_sum -> C=1700", lambda: j_seg(acc, d_ci, C))

    def _cumsum_bdiff(a, starts):
        tot = jnp.concatenate([jnp.zeros(1, a.dtype), jnp.cumsum(a)])
        return tot[starts[1:]] - tot[starts[:-1]]

    j_cb = jax.jit(_cumsum_bdiff)
    bench("cumsum+bdiff -> L (lm_starts)", lambda: j_cb(acc, d_ls))
    bench("cumsum+bdiff -> C (cam_starts)", lambda: j_cb(acc, d_cs))

    j_fma = jax.jit(lambda Wm, a: Wm[0] * a + Wm[1] * a + Wm[2] * a
                    + Wm[3] * a + Wm[4] * a + Wm[5] * a)
    bench("elementwise 6-term fma chain", lambda: j_fma(W, acc))

    # --- composite directions, scatter vs dual ---
    def wt_scatter(Wm, xbv, ci_, li_):
        xg = [xbv[:, i][ci_] for i in range(6)]
        t = []
        for j in range(3):
            a = jnp.zeros(Mp, Wm.dtype)
            for i in range(6):
                a = a + Wm[3 * i + j] * xg[i]
            t.append(jax.ops.segment_sum(a, li_, num_segments=L))
        return jnp.stack(t)

    def wt_dual(Wlm, xbv, cil_, ls_):
        xg = [xbv[:, i][cil_] for i in range(6)]
        t = []
        for j in range(3):
            a = jnp.zeros(Mp, Wlm.dtype)
            for i in range(6):
                a = a + Wlm[3 * i + j] * xg[i]
            t.append(_cumsum_bdiff(a, ls_))
        return jnp.stack(t)

    def w_dot_lm(Wm, t3v, li_, cs_):
        tg = [t3v[j][li_] for j in range(3)]
        cols = []
        for i in range(6):
            a = Wm[3 * i] * tg[0] + Wm[3 * i + 1] * tg[1] + Wm[3 * i + 2] * tg[2]
            cols.append(_cumsum_bdiff(a, cs_))
        return jnp.stack(cols, axis=1)

    j_sc = jax.jit(wt_scatter)
    j_du = jax.jit(wt_dual)
    j_wl = jax.jit(w_dot_lm)
    bench("W_T_dot_cam scatter (as shipped)", lambda: j_sc(W, xb, d_ci, d_li))
    bench("W_T_dot_cam dual cumsum", lambda: j_du(W_l, xb, d_ci_l, d_ls))
    bench("W_dot_lm cumsum (as shipped)", lambda: j_wl(W, t3, d_li, d_cs))

    j_rg = jax.jit(lambda Wm, lo: jnp.stack([Wm[k][lo] for k in range(18)]))
    bench("regather W_l (18 rows)", lambda: j_rg(W, d_lorder))

    # single fused gather of a (Mp, 6) block vs 6 row gathers
    j_g6 = jax.jit(lambda xbv, ci_: xbv[ci_])
    bench("gather xb[ci] (one (Mp,6) gather)", lambda: j_g6(xb, d_ci))


# Appended: padded-gather matvec variants (round 4). The row-gather matvec
# pays ~39 ms PER GATHER at Mp=5M; a single (Mp, k) gather with k lanes
# costs ~11 ms because it is one op (lane padding to 128 costs HBM bytes,
# not ops). These variants measure complete directions built that way.
def variants():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import time, os

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    C, L, Mp = 1700, 1000000, 5000000
    rng = np.random.default_rng(0)
    ci = np.sort(rng.integers(0, C, Mp)).astype(np.int32)
    li = rng.integers(0, L, Mp).astype(np.int32)
    lorder = np.argsort(li, kind="stable").astype(np.int32)
    ci_l = ci[lorder]
    cam_starts = np.searchsorted(ci, np.arange(C + 1)).astype(np.int32)
    lm_starts = np.searchsorted(li[lorder], np.arange(L + 1)).astype(np.int32)
    W = jnp.asarray(rng.standard_normal((18, Mp)), jnp.float32)
    W_l = jnp.asarray(np.asarray(W)[:, lorder])
    xb = jnp.asarray(rng.standard_normal((C, 6)), jnp.float32)
    t3T = jnp.asarray(rng.standard_normal((L, 3)), jnp.float32)
    d = dict(ci=jnp.asarray(ci), li=jnp.asarray(li), ci_l=jnp.asarray(ci_l),
             cs=jnp.asarray(cam_starts), ls=jnp.asarray(lm_starts),
             lorder=jnp.asarray(lorder))

    def bench(name, fn, *a):
        out = fn(*a); jax.block_until_ready(out)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter(); out = fn(*a); jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        print(f"{name:40s} {best*1000:9.2f} ms")
        return out

    def cbdiff(a, starts):
        tot = jnp.concatenate([jnp.zeros(1, a.dtype), jnp.cumsum(a)])
        return tot[starts[1:]] - tot[starts[:-1]]

    # W^T x, dual order, one padded gather + lane slices
    def wt_dual_padded(Wlm, xbv, cil, ls):
        xg = xbv[cil]                       # (Mp, 6) one gather
        t = []
        for j in range(3):
            a = Wlm[j] * xg[:, 0]
            for i in range(1, 6):
                a = a + Wlm[3 * i + j] * xg[:, i]
            t.append(cbdiff(a, ls))
        return jnp.stack(t)

    # same but transpose gathered block to component-major first
    def wt_dual_padded_T(Wlm, xbv, cil, ls):
        xg = xbv[cil].T                     # (6, Mp)
        t = []
        for j in range(3):
            a = Wlm[j] * xg[0]
            for i in range(1, 6):
                a = a + Wlm[3 * i + j] * xg[i]
            t.append(cbdiff(a, ls))
        return jnp.stack(t)

    # batched cumsum: build (3, Mp) accs then one cumsum(axis=1)
    def wt_dual_padded_batched(Wlm, xbv, cil, ls):
        xg = xbv[cil]
        accs = jnp.stack([
            sum(Wlm[3 * i + j] * xg[:, i] for i in range(6)) for j in range(3)
        ])                                   # (3, Mp)
        tot = jnp.concatenate(
            [jnp.zeros((3, 1), accs.dtype), jnp.cumsum(accs, axis=1)], axis=1)
        return tot[:, ls[1:]] - tot[:, ls[:-1]]

    # W x_lm, one padded gather
    def wdl_padded(Wm, t3t, li_, cs):
        tg = t3t[li_]                        # (Mp, 3) one gather
        cols = []
        for i in range(6):
            a = Wm[3 * i] * tg[:, 0] + Wm[3 * i + 1] * tg[:, 1] + Wm[3 * i + 2] * tg[:, 2]
            cols.append(cbdiff(a, cs))
        return jnp.stack(cols, axis=1)

    # scatter version with padded gather (no dual copy needed)
    def wt_scatter_padded(Wm, xbv, ci_, li_):
        xg = xbv[ci_]
        t = []
        for j in range(3):
            a = sum(Wm[3 * i + j] * xg[:, i] for i in range(6))
            t.append(jax.ops.segment_sum(a, li_, num_segments=L))
        return jnp.stack(t)

    # one-gather W_l regather via (Mp, 18) padded transpose round-trip
    def regather_padded(Wm, lo):
        return Wm.T[lo].T                    # (18, Mp) -> (Mp,18) gather -> back

    j1 = jax.jit(wt_dual_padded); j2 = jax.jit(wdl_padded)
    j3 = jax.jit(wt_scatter_padded); j4 = jax.jit(regather_padded)
    j5 = jax.jit(wt_dual_padded_T); j6 = jax.jit(wt_dual_padded_batched)
    bench("W_T_dot_cam dual PADDED gather", j1, W_l, xb, d["ci_l"], d["ls"])
    bench("W_T_dot_cam dual PADDED + transpose", j5, W_l, xb, d["ci_l"], d["ls"])
    bench("W_T_dot_cam dual PADDED batched-cumsum", j6, W_l, xb, d["ci_l"], d["ls"])
    bench("W_dot_lm PADDED gather", j2, W, t3T, d["li"], d["cs"])
    bench("W_T_dot_cam scatter PADDED gather", j3, W, xb, d["ci"], d["li"])
    bench("regather W_l one padded gather", j4, W, d["lorder"])


if __name__ == "__main__":
    import sys as _s
    if "--variants" in _s.argv:
        variants()
    else:
        main()
