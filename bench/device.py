"""Device checks and labels shared by the benchmark entry points.

A benchmark measures the GPU or nothing: without one it exits non-zero,
unless the caller asked for the CPU explicitly with ``JAX_PLATFORMS=cpu``
(for debugging the harness at small sizes; its times are CPU times).
Every result row names the device it ran on.
"""

from __future__ import annotations

import os
import subprocess
import sys


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them, one card
    per line; a note in their place where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def require_gpu() -> None:
    """Exit non-zero unless JAX runs on a GPU or the caller chose the CPU."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu":
        return
    if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        print("note: JAX_PLATFORMS=cpu — times below are CPU times", file=sys.stderr)
        return
    sys.exit(f"no GPU: JAX backend is {backend!r} (set JAX_PLATFORMS=cpu to run on the CPU)")


def device_fields() -> dict:
    """Device labels for a result row."""
    import jax

    devs = jax.devices()
    return {
        "device": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "n_devices": len(devs),
        "gpu": nvidia_smi() if devs[0].platform == "gpu" else None,
    }
