"""Bring-up check: drive the solver's main path once on one GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # four cards: the sharded routes only

Each phase builds a benchmark configuration at its published size (random
data from a fixed seed), solves it through the normal entry points twice
(once to compile, once warm) and checks chi2 against the converged reference
recorded in bench/standin_cache.json and bench/baseline_cache.json.  Any
failed gate or exception exits non-zero.  Without a GPU the script exits
non-zero before any phase runs.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "bench"))

import numpy as np  # noqa: E402

# float32 with float32 accumulation stays near 1e-7; TF32 products (~3
# decimal digits) land near 1e-3, so this gate catches a precision setting
# that does not take effect
PRECISION_RTOL = 1e-5
# sharded-equals-single-device tolerance (same as __graft_entry__.py)
SHARD_RTOL = 2e-4


class PhaseFailed(AssertionError):
    pass


def reference_chi2() -> dict:
    """Converged reference chi2 of each configuration, from the tracked
    caches (the CPU stand-in is never run here)."""
    with open(os.path.join(ROOT, "bench", "standin_cache.json")) as f:
        standin = json.load(f)
    with open(os.path.join(ROOT, "bench", "baseline_cache.json")) as f:
        baseline = json.load(f)
    return {
        "pose_graph_se3": baseline["chi2"],
        "pose_graph_se2_dense": standin["se2_manhattan_3500"]["chi2"],
        "ba_ladybug": standin["ba_ladybug_49_7000"]["chi2"],
        "ba_venice_mini": standin["venice_mini_ref"]["chi2"],
    }


def warm(run):
    """(result, warm wall seconds): one call to compile, one timed.  Every
    solve here is one program or ends in a host readback, so waiting for
    its outputs waits for all of its device work."""
    import jax

    jax.block_until_ready(run())
    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    return out, time.perf_counter() - t0


def gate(phase, route, chi2, ref, factor, iters, wall):
    """Print the phase line; raise unless chi2 is finite and <= ref*factor."""
    chi2 = float(chi2)
    ok = bool(np.isfinite(chi2) and chi2 <= ref * factor)
    print(
        f"phase={phase} route={route} chi2={chi2!r} ref_chi2={ref!r} "
        f"gate=<={factor}x iters={iters} warm_s={wall!r} ok={ok}",
        flush=True,
    )
    if not ok:
        raise PhaseFailed(f"{phase}: chi2 {chi2} above {factor} x {ref}")
    return chi2


def expect_route(phase, got, want):
    if got != want:
        raise PhaseFailed(f"{phase}: routed {got!r}, expected {want!r}")


def _rel_err(y, y_ref):
    y = np.asarray(y, np.float64)
    return float(np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref))


def phase_precision(n_poses=2500, n=4096, seed=0):
    """float32 products must stay float32: the ELL matvec that solve_ell
    uses, and one dense matmul at the size of the dense Schur system at the
    schur_dense limit, each against a float64 numpy product."""
    import jax
    import jax.numpy as jnp

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver.bcsr import assemble_ell, build_ell_direct, ell_direct_matvec

    g = build.pose_graph(synth.se3_sphere(n_poses=n_poses, seed=seed), dtype=jnp.float32)
    plan = build_ell_direct(g)
    He, _, _ = jax.jit(lambda gr: assemble_ell(gr, plan))(g)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(plan.nb * plan.d).astype(np.float32)
    cols = jnp.asarray(plan.cols)
    y = jax.jit(ell_direct_matvec)(He, cols, jnp.asarray(x))
    He64 = np.asarray(He, np.float64)
    x64 = x.astype(np.float64).reshape(plan.nb, plan.d)
    y_ref = np.einsum("rkij,rkj->ri", He64, x64[plan.cols]).reshape(-1)
    err_ell = _rel_err(y, y_ref)

    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    C_ref = A.astype(np.float64) @ B.astype(np.float64)
    err_mm = _rel_err(jax.jit(jnp.matmul)(A, B), C_ref)
    # control, not gated: the same product at the backend's default precision
    with jax.default_matmul_precision("default"):
        err_default = _rel_err(jax.jit(lambda a, b: a @ b)(A, B), C_ref)
    ok = err_ell <= PRECISION_RTOL and err_mm <= PRECISION_RTOL
    print(
        f"phase=precision ell_matvec_rel_err={err_ell!r} matmul{n}_rel_err={err_mm!r} "
        f"gate=<={PRECISION_RTOL} default_precision_matmul_rel_err={err_default!r} "
        f"matmul_precision={jax.config.jax_default_matmul_precision} ok={ok}",
        flush=True,
    )
    if not ok:
        raise PhaseFailed(f"precision: rel err ell {err_ell}, matmul {err_mm}")
    return err_ell, err_mm


def phase_pose_graph_se3(ref_chi2, n_poses=2500, dense_dof_limit=12000, seed=0):
    """Config 3 (sphere2500): the bench.py path, then solve_auto."""
    import jax.numpy as jnp

    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, route_auto, solve_auto
    from pyslam_tpu.solver.bcsr import build_ell_direct, solve_ell

    g = build.pose_graph(synth.se3_sphere(n_poses=n_poses, seed=seed), dtype=jnp.float32)
    plan = build_ell_direct(g)
    opts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
    (_, info), wall = warm(
        lambda: solve_ell(g, opts, plan=plan, pcg_rtol=3e-6, pcg_max_iters=120)
    )
    gate("pose_graph_se3", "solve_ell", info.chi2, ref_chi2, 1.001,
         int(info.iterations), wall)
    route = route_auto(g, dense_dof_limit=dense_dof_limit)
    expect_route("pose_graph_se3/auto", route, "ell")
    (_, info), wall = warm(lambda: solve_auto(g, opts, dense_dof_limit=dense_dof_limit))
    return gate("pose_graph_se3/auto", route, info.chi2, ref_chi2, 1.01,
                int(info.iterations), wall)


def phase_pose_graph_se2_dense(ref_chi2, n_poses=3500, seed=1):
    """Config 2 (M3500 through the g2o round trip): dense Gauss-Newton."""
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import g2o, synth
    from pyslam_tpu.solver import Options, route_auto, solve_auto

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m3500.g2o")
        g2o.write_g2o(path, synth.se2_manhattan(n_poses=n_poses, seed=seed))
        data = g2o.read_g2o(path)
    g = build.pose_graph(data)
    route = route_auto(g)
    expect_route("pose_graph_se2_dense", route, "dense")
    opts = Options(method="gn", max_iters=30, min_cost_decrease=0.999)
    (_, info), wall = warm(lambda: solve_auto(g, opts))
    return gate("pose_graph_se2_dense", route, info.chi2, ref_chi2, 1.01,
                int(info.iterations), wall)


def phase_ba_ladybug(ref_chi2, n_cams=49, n_pts=7000, seed=0):
    """Config 4 (Ladybug-class BA): Schur PCG, then solve_auto (dense S)."""
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, route_auto, solve_auto, solve_schur

    g = build.ba_graph(synth.ba_synthetic(n_cams=n_cams, n_pts=n_pts, seed=seed))
    opts = Options(method="lm", max_iters=25)
    (_, info), wall = warm(
        lambda: solve_schur(g, opts, mode="pcg", pcg_rtol=1e-4, pcg_max_iters=30)
    )
    gate("ba_ladybug", "schur_pcg", info.chi2, ref_chi2, 1.01, int(info.iterations), wall)
    route = route_auto(g)
    expect_route("ba_ladybug/auto", route, "schur_dense")
    (_, info), wall = warm(lambda: solve_auto(g, opts))
    return gate("ba_ladybug/auto", route, info.chi2, ref_chi2, 1.01,
                int(info.iterations), wall)


def phase_ba_venice_mini(ref_chi2, n_cams=300, n_pts=60000, obs_per_pt=6, seed=0):
    """Config 5 (Venice-mini BA): landmark-sharded Schur on a 1-device mesh,
    which runs shard_map on the card."""
    from pyslam_tpu.dist import make_mesh, solve_schur_sharded
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options

    g = build.ba_graph(
        synth.ba_synthetic(n_cams=n_cams, n_pts=n_pts, obs_per_pt=obs_per_pt, seed=seed)
    )
    mesh = make_mesh(1, axis_name="l")
    opts = Options(method="lm", max_iters=15)
    (_, chi2, hist), wall = warm(
        lambda: solve_schur_sharded(g, mesh, opts, pcg_rtol=1e-4, pcg_max_iters=30)
    )
    return gate("ba_venice_mini", "schur_reduce[1]", chi2, ref_chi2, 1.001,
                len(hist) - 1, wall)


def _peaks(devices):
    """Peak bytes each device has held; None where the device keeps no
    statistics (the CPU)."""
    out = []
    for d in devices:
        stats = d.memory_stats()
        out.append(None if not stats else int(stats.get("peak_bytes_in_use", 0)))
    return out


def _compare(phase, route, chi2_n, chi2_1, devices, wall_n, wall_1):
    chi2_n, chi2_1 = float(chi2_n), float(chi2_1)
    rel = abs(chi2_n - chi2_1) / max(abs(chi2_1), 1.0)
    peaks = _peaks(devices)
    ok = bool(np.isfinite(chi2_n) and rel <= SHARD_RTOL)
    # code that has only ever run on one device may put everything on the
    # first: every card must have held work
    holds = all(p is None or p > 0 for p in peaks)
    print(
        f"phase={phase} route={route} cards={len(devices)} chi2={chi2_n!r} "
        f"chi2_1card={chi2_1!r} rel_diff={rel!r} gate=<={SHARD_RTOL} "
        f"warm_s={wall_n!r} warm_s_1card={wall_1!r} "
        f"peak_bytes_in_use={peaks} ok={ok and holds}",
        flush=True,
    )
    if not ok:
        raise PhaseFailed(f"{phase}: {len(devices)}-card chi2 {chi2_n} != 1-card {chi2_1}")
    if not holds:
        raise PhaseFailed(f"{phase}: a card held no work: {peaks}")
    return rel


def phase_cards(n_cards=4, n_cams=300, n_pts=60000, obs_per_pt=6, n_poses=2500, seed=0):
    """The sharded routes on ``n_cards`` devices against one device."""
    import jax
    import jax.numpy as jnp

    from pyslam_tpu.dist import make_mesh, solve_pose_sharded, solve_schur_sharded
    from pyslam_tpu.dist.schur_cm import solve_schur_cm
    from pyslam_tpu.graph import build
    from pyslam_tpu.io import synth
    from pyslam_tpu.solver import Options, route_auto, solve_auto

    devices = jax.devices()[:n_cards]
    if len(devices) < n_cards:
        raise PhaseFailed(f"need {n_cards} devices, have {len(jax.devices())}")
    mesh_n, mesh_1 = make_mesh(n_cards, axis_name="l"), make_mesh(1, axis_name="l")
    ba = build.ba_graph(
        synth.ba_synthetic(n_cams=n_cams, n_pts=n_pts, obs_per_pt=obs_per_pt, seed=seed)
    )
    opts = Options(method="lm", max_iters=15)

    route = route_auto(ba, mesh=mesh_n)
    expect_route("cards/ba_auto", route, "schur_reduce")
    (_, hist_n), wall_n = warm(lambda: solve_auto(ba, opts, mesh=mesh_n))
    (_, chi2_1, _), wall_1 = warm(lambda: solve_schur_sharded(ba, mesh_1, opts))
    _compare("cards/ba_auto", route, hist_n[-1], chi2_1, devices, wall_n, wall_1)

    (_, chi2_n, _), wall_n = warm(lambda: solve_schur_cm(ba, mesh_n, opts))
    (_, chi2_1, _), wall_1 = warm(lambda: solve_schur_cm(ba, mesh_1, opts))
    _compare("cards/schur_cm", "schur_cm", chi2_n, chi2_1, devices, wall_n, wall_1)

    g = build.pose_graph(synth.se3_sphere(n_poses=n_poses, seed=seed), dtype=jnp.float32)
    popts = Options(method="lm", max_iters=30, min_cost_decrease=0.999)
    mp_n, mp_1 = make_mesh(n_cards, axis_name="p"), make_mesh(1, axis_name="p")
    (_, chi2_n, _), wall_n = warm(lambda: solve_pose_sharded(g, mp_n, popts))
    (_, chi2_1, _), wall_1 = warm(lambda: solve_pose_sharded(g, mp_1, popts))
    _compare("cards/pose_sharded", "pose_sharded", chi2_n, chi2_1, devices, wall_n, wall_1)


def require_gpus(n_cards):
    """Exit non-zero, printing no result, unless JAX runs on enough GPUs."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX backend is {backend!r})")
    if len(jax.devices()) < n_cards:
        sys.exit(f"chip_smoke: need {n_cards} GPUs, JAX sees {len(jax.devices())}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded routes, 4 cards against 1")
    args = ap.parse_args(argv)

    from device import nvidia_smi
    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    require_gpus(args.cards)

    import jax

    print(f"gpu: {nvidia_smi()}", flush=True)
    print("devices: " + ", ".join(f"{d} [{d.device_kind}]" for d in jax.devices()),
          flush=True)
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_cards(4)
    else:
        ref = reference_chi2()
        phase_precision()
        phase_pose_graph_se3(ref["pose_graph_se3"])
        phase_pose_graph_se2_dense(ref["pose_graph_se2_dense"])
        phase_ba_ladybug(ref["ba_ladybug"])
        phase_ba_venice_mini(ref["ba_venice_mini"])
    print(f"total_s={time.perf_counter() - t0!r}", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
