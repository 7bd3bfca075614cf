"""The mesh-as-jit-arguments multistep path (million-cell compile payload).

Above Simulation._MESH_ARGS_MIN_NODES the multistep entry points thread the
per-node mesh/geometry buffers as jit ARGUMENTS instead of closure
constants, so the lowered program carries parameters, not ~300 B/node of
inlined dense literals.

The two program forms are numerically equivalent but not bitwise identical:
with constants XLA folds/fuses differently, so we pin agreement at the f32
ulp-accumulation level over 5 coupled implicit iterations.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from su2_tpu.config import Config
from su2_tpu.driver import Simulation

_COMBUSTION = "/root/reference/Test_Cases/TURBOLENT/TURBOLENT_COMBUSTION"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(_COMBUSTION), reason="reference test cases not found")


def _run(mode: str):
    prev = os.environ.get("SU2_TPU_MESH_ARGS")
    os.environ["SU2_TPU_MESH_ARGS"] = mode
    try:
        cfg = Config(os.path.join(_COMBUSTION,
                                  "my_combustion_second_chem_PaSR.cfg"),
                     overrides={"RESTART_SOL": "NO"})
        sim = Simulation(cfg, dtype=jnp.float32)
        q0, mu_t0, gk0, sk0 = sim.initial_turb_state()
        ignites = jnp.zeros((5,), bool)
        carry, ys = sim.rans_multistep(sim.u0, sim.t0, q0, mu_t0, gk0, sk0,
                                       ignites)
        assert sim._multistep_args == (mode == "1")
        return np.asarray(carry[0]), np.asarray(ys[0])
    finally:
        if prev is None:
            del os.environ["SU2_TPU_MESH_ARGS"]
        else:
            os.environ["SU2_TPU_MESH_ARGS"] = prev


@pytest.mark.slow
def test_mesh_args_path_matches_constant_closure_path():
    u_const, rms_const = _run("0")
    u_args, rms_args = _run("1")
    scale = np.abs(u_const).max(axis=0)
    rel = (np.abs(u_args - u_const) / np.maximum(scale, 1e-30)).max()
    # ulp-level accumulation over 5 coupled implicit f32 iterations; the
    # round-4 weak-typed SST constants (all-f32 source arithmetic, was
    # f64-then-truncate under x64) moved the observed gap 2e-5 -> 5.2e-5
    assert rel < 1e-4, rel
    assert np.abs(rms_args - rms_const).max() < 2e-4
