"""Where the persistent compilation cache lands: JAX_COMPILATION_CACHE_DIR
when it is set (nothing is set in code), else <repo>/.jax_cache."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import su2_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
