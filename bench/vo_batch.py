"""VO THROUGHPUT mode measurement (VERDICT r4 #6): batched K-frame
tracking against a fixed keyframe vs the sequential per-frame loop.

Per-frame latency can be bound by the host: one upload and one dispatch per
frame against a short device computation (bench/vo_overlap.py measures how
far prefetching hides the upload).  ``DenseRGBDPipeline.track_batch``
amortizes that latency over K frames: one (K, H, W) upload, one vmapped coarse-to-fine
dispatch.  This script measures fps at K in {1, 4, 16} on VGA frames and
checks the batched trajectory matches the sequential one.

Run on the GPU: python bench/vo_batch.py [--frames 48]
Appends one JSON line to bench/results.jsonl (config "vo_batch").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pyslam_tpu.utils import enable_compile_cache

from vo_overlap import CAM, make_frames


def build_pipe():
    from pyslam_tpu.pipelines import DenseRGBDPipeline
    from pyslam_tpu.sensors import RGBDCamera

    return DenseRGBDPipeline(
        RGBDCamera(**CAM), pyrlevels=4, keyframe_trans_thresh=1e9
    )


def run_sequential(frames):
    pipe = build_pipe()
    pipe.track(*frames[0])
    pipe.track(*frames[1])  # compile
    t0 = time.perf_counter()
    for im, depth in frames[2:]:
        pipe.track(im, depth)
    wall = time.perf_counter() - t0
    return (len(frames) - 2) / wall, np.stack(pipe.T_c_w)


def run_batched(frames, K):
    pipe = build_pipe()
    pipe.track(*frames[0])
    ims = [im for im, _ in frames[1:]]
    n = (len(ims) // K) * K
    pipe.track_batch(ims[:K])  # compile
    pipe2 = build_pipe()
    pipe2.track(*frames[0])
    t0 = time.perf_counter()
    for s in range(0, n, K):
        pipe2.track_batch(ims[s : s + K])
    wall = time.perf_counter() - t0
    return n / wall, np.stack(pipe2.T_c_w)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results.jsonl"))
    args = ap.parse_args()

    import jax

    enable_compile_cache()
    frames = make_frames(args.frames)
    fps_seq, traj_seq = run_sequential(frames)
    print(f"sequential: {fps_seq:.1f} fps", flush=True)
    rows = {}
    max_err = {}
    for K in (4, 16):
        fps, traj = run_batched(frames, K)
        rows[f"batch{K}_fps"] = round(fps, 2)
        n = min(len(traj), len(traj_seq))
        max_err[K] = float(np.abs(traj[:n] - traj_seq[:n]).max())
        print(f"K={K}: {fps:.1f} fps (traj max diff {max_err[K]:.2e})", flush=True)
    rec = dict(
        config="vo_batch", frames=args.frames, sequential_fps=round(fps_seq, 2),
        **rows,
        traj_max_diff=max(max_err.values()),
        device=jax.devices()[0].platform,
    )
    line = json.dumps(rec)
    print(line, flush=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
