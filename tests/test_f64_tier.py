"""f64 precision-tier selection (SU2_TPU_DTYPE=float64, driver.py main).

The high-precision tier runs the same solver in float64.  The test drives
the CLI in a child process on the CPU with the tier selected from the
environment, and pins its printed residual trajectory against an
in-process float64 Simulation of the same stand-in case.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(cfg_path, cwd, niter=3):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update({"PYTHONPATH": ROOT, "SU2_TPU_DTYPE": "float64",
                "SU2_TPU_CHUNK": "1", "JAX_PLATFORMS": "cpu",
                "SU2_TPU_PLATFORM": "cpu"})
    out = subprocess.run(
        [sys.executable, "-m", "su2_tpu", cfg_path, str(niter)],
        capture_output=True, text=True, env=env, timeout=900, cwd=cwd)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = []
    for line in out.stdout.splitlines():
        parts = line.split()
        if len(parts) > 4 and parts[1] == "Res[Rho]:":
            rows.append((float(parts[2]), float(parts[4])))
    return rows


def test_f64_tier_cli_matches_in_process(standin_dir, tmp_path):
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation

    cfg_path = os.path.join(standin_dir, "case.cfg")
    rows = _run_cli(cfg_path, str(tmp_path))
    assert len(rows) == 3
    sim = Simulation(Config(cfg_path), dtype=jnp.float64)
    _, _, hist, _ = sim.run(3, quiet=True)
    lay = sim.lay
    for (r, e), h in zip(rows, hist):
        assert r == pytest.approx(h[lay.RHO], abs=2e-6)
        assert e == pytest.approx(h[lay.RHOE], abs=2e-6)
    # the CLI wrote its history and restart into the working directory
    assert (tmp_path / "history.dat").exists()
    assert (tmp_path / "restart_flow.dat").exists()
