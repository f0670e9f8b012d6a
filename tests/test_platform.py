"""Process-level settings: where the compile cache goes, and what
``import pyslam_tpu`` sets and loads."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
import jax
import pyslam_tpu
from pyslam_tpu.utils import enable_compile_cache
path = enable_compile_cache()
print(json.dumps({
    "returned": path,
    "config": jax.config.jax_compilation_cache_dir,
    "precision": jax.config.jax_default_matmul_precision,
    "cv2": "cv2" in sys.modules,
    "matplotlib": "matplotlib" in sys.modules,
}))
"""


def _probe(env_cache_dir):
    import json

    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache_dir
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, timeout=300, cwd=ROOT, check=True,
    ).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_placement(from_env, tmp_path):
    if from_env:
        outside = str(tmp_path / "cache")
        got = _probe(outside)
        # JAX's own reading of the variable stands; nothing overrides it
        assert got["returned"] == outside
        assert got["config"] == outside
    else:
        got = _probe(None)
        want = os.path.join(ROOT, ".jax_cache")
        assert got["returned"] == want
        assert got["config"] == want


def test_import_sets_precision_and_loads_no_optional_deps():
    got = _probe(None)
    assert got["precision"] == "highest"
    assert not got["cv2"]
    assert not got["matplotlib"]
