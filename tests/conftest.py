"""Test harness configuration (SURVEY.md §4).

Tests run on the CPU backend with x64 enabled and 8 virtual devices, so that:
  * Jacobian checks against jax.jacfwd/jacrev are tight (f64),
  * multi-device sharding (shard_map collectives, partitioner, Schur
    reduction) is exercised on an 8-device mesh without several GPUs.

The CPU backend is selected by in-process config before any backend use, so
that no test worker ever opens a GPU, whatever the environment says.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# NOTE (round 2): XLA:CPU's backend_compile segfaults after ~200 fresh
# compiles in one long-running process (reproduced 3x at ~85% of a cold
# suite, also once corrupting a concurrently-written cache entry).  With a
# WARM cache the suite is all cache hits and never crashes.  If the cache
# is ever purged, re-warm it chunk-wise first:  bash scripts/warm_test_cache.sh
from pyslam_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# XLA:CPU in this jaxlib dies (SIGSEGV) when ~240 executables have been
# loaded into one process — reproduced at the same suite position across
# cold compiles, cache writes, AND cache reads.  Dropping the in-process
# jit caches every N tests unloads executables and stays under the limit;
# with the warm on-disk cache, re-loading a dropped program costs ms.
_TEST_COUNTER = {"n": 0}


@pytest.fixture(autouse=True)
def _xla_cpu_executable_limit_workaround():
    yield
    _TEST_COUNTER["n"] += 1
    if _TEST_COUNTER["n"] % 60 == 0:
        jax.clear_caches()
