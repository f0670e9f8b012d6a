"""VO upload/compute overlap measurement.

The VGA tracking loop uploads every frame from the host (over PCIe on a
GPU) before a short device computation.  Double-buffering hides the upload
IF the device overlaps an async ``device_put`` with a running computation — this script measures exactly
that, three ways:

  A. baseline:   track(frame_i) with the upload inside the call
  B. prefetch:   pipeline.prefetch(frame_{i+1}) issued right BEFORE
                 track(frame_i) blocks — the transfer has the whole fused
                 solve to hide under
  C. raw probe:  device_put(X) followed immediately by a long jitted
                 matmul chain on OTHER data, then block both — if wall <
                 (transfer + compute) the device overlaps the copy with compute

Run on the GPU: python bench/vo_overlap.py [--frames 40]
Appends one JSON line to bench/results.jsonl (config "vo_overlap").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

W, H, Z0 = 640, 480, 4.0
CAM = dict(cu=319.5, cv=239.5, fu=525.0, fv=525.0, w=W, h=H)


def tex(x, y):
    return (
        0.5
        + 0.2 * np.sin(2.5 * x) * np.cos(1.8 * y)
        + 0.15 * np.sin(0.9 * x + 1.3 * y)
        + 0.1 * np.cos(5.1 * x - 2.2 * y)
    )


def render(t):
    u, v = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    zc = Z0 - t[2]
    xw = (u - CAM["cu"]) / CAM["fu"] * zc + t[0]
    yw = (v - CAM["cv"]) / CAM["fv"] * zc + t[1]
    im = np.clip(tex(xw, yw), 0.0, 1.0)
    return (im * 255).astype(np.uint8), np.full((H, W), zc, np.float32)


def make_frames(n):
    return [
        render(np.array([0.02 * k, 0.01 * np.sin(k / 2), 0.0])) for k in range(n)
    ]


def run_baseline(frames):
    from pyslam_tpu.pipelines import DenseRGBDPipeline
    from pyslam_tpu.sensors import RGBDCamera

    pipe = DenseRGBDPipeline(RGBDCamera(**CAM), pyrlevels=4, keyframe_trans_thresh=1e9)
    pipe.track(*frames[0])
    pipe.track(*frames[1])  # compile
    t0 = time.perf_counter()
    for im, depth in frames[2:]:
        pipe.track(im, depth)
    wall = time.perf_counter() - t0
    return (len(frames) - 2) / wall


def run_prefetch(frames):
    from pyslam_tpu.pipelines import DenseRGBDPipeline
    from pyslam_tpu.sensors import RGBDCamera

    pipe = DenseRGBDPipeline(RGBDCamera(**CAM), pyrlevels=4, keyframe_trans_thresh=1e9)
    pipe.track(*frames[0])
    pipe.track(*frames[1])  # compile
    t0 = time.perf_counter()
    h = pipe.prefetch(frames[2][0])
    for k in range(2, len(frames)):
        h_next = pipe.prefetch(frames[k + 1][0]) if k + 1 < len(frames) else None
        pipe.track(h, frames[k][1])
        h = h_next
    wall = time.perf_counter() - t0
    return (len(frames) - 2) / wall


def raw_overlap_probe():
    """Does the device overlap an async host-to-device copy with compute?"""
    import jax
    import jax.numpy as jnp

    X = np.random.default_rng(0).integers(0, 255, (H, W), np.uint8)

    @jax.jit
    def burn(a):
        for _ in range(60):
            a = jnp.tanh(a @ a)
        return a

    a = jnp.ones((1024, 1024), jnp.float32) * 0.01
    jax.block_until_ready(burn(a))  # compile

    t0 = time.perf_counter()
    jax.block_until_ready(jax.device_put(X))
    t_upload = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(burn(a))
    t_compute = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = jax.device_put(X)
    r = burn(a)
    jax.block_until_ready((d, r))
    t_both = time.perf_counter() - t0
    return dict(
        upload_ms=t_upload * 1e3,
        compute_ms=t_compute * 1e3,
        both_ms=t_both * 1e3,
        overlap_fraction=float(
            np.clip((t_upload + t_compute - t_both) / max(min(t_upload, t_compute), 1e-9), 0, 1)
        ),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl"))
    args = ap.parse_args()

    import jax

    from pyslam_tpu.utils import enable_compile_cache

    enable_compile_cache()
    probe = raw_overlap_probe()
    print("raw probe:", json.dumps(probe), flush=True)
    frames = make_frames(args.frames)
    fps_a = run_baseline(frames)
    print(f"baseline: {fps_a:.1f} fps", flush=True)
    fps_b = run_prefetch(frames)
    print(f"prefetch: {fps_b:.1f} fps", flush=True)
    rec = dict(
        config="vo_overlap", frames=args.frames, baseline_fps=fps_a,
        prefetch_fps=fps_b, probe=probe, device=jax.devices()[0].platform,
    )
    line = json.dumps(rec)
    print(line, flush=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
