"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins, otherwise a
fixed directory inside the checkout."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from comprox_tpu.utils.cache import DEFAULT_DIR

REPO = Path(__file__).resolve().parents[1]
PROBE = (
    "from comprox_tpu.utils.cache import enable_compilation_cache\n"
    "enable_compilation_cache()\n"
    "import jax\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c", PROBE],
        env=env,
        cwd=tmp_path,  # the default must not depend on the working dir
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    got = r.stdout.strip().splitlines()[-1]
    if env_dir:
        assert got == str(tmp_path)
    else:
        assert got == str(REPO / ".jax_cache") == str(DEFAULT_DIR)
        ignored = (REPO / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored
