"""Device-mesh utilities for multi-device / multi-host solving (SURVEY.md §2.3).

The communication model is pure XLA collectives over an explicit
``jax.sharding.Mesh`` (psum / all_gather / reduce_scatter, which XLA hands
to NCCL on GPUs) — the on-device replacement for the distributed backend
the reference lacks.  The cards of one H100 host are joined all to all by
NVLink, so meshes are flat and follow the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "f") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (factor-parallel axis)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def init_distributed(coordinator: str | None = None, **kw):
    """Multi-host bootstrap: jax.distributed.initialize (one process per
    host; collectives then span the full pod slice).  No-op when already
    initialized or single-host."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator, **kw)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process


__all__ = ["Mesh", "NamedSharding", "P", "make_mesh", "init_distributed"]
