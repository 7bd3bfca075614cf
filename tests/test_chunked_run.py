"""Chunked device-loop driver (run(chunk=K) -> rans_multistep /
flow_multistep lax.scan programs): trajectory identical to the
per-iteration path, history numbering absolute across chunk boundaries
and the trailing remainder."""

import os

import jax.numpy as jnp
import numpy as np

import __graft_entry__ as g
from su2_tpu.config import Config
from su2_tpu.driver import Simulation


def _tiny_sim(turbulent=True):
    if turbulent:
        return g._flagship_sim(jnp.float64, tiny=True)
    import tempfile
    from su2_tpu import testcase
    from su2_tpu.geometry.structured import channel_mesh
    text = testcase.cfg_text().replace("KIND_TURB_MODEL= SST",
                                       "KIND_TURB_MODEL= NONE")
    cfg = Config(text=text)
    cfg.base_dir = tempfile.mkdtemp(prefix="su2_chunked_")
    testcase.write_library(cfg.base_dir)
    return Simulation(cfg, dtype=jnp.float64, raw_mesh=channel_mesh(17, 9))


def test_chunked_matches_periter_turbulent():
    sim = _tiny_sim(turbulent=True)
    u1, t1, h1, _ = sim.run(niter=7, quiet=True)
    u2, t2, h2, _ = sim.run(niter=7, quiet=True, chunk=3)
    assert h1.shape == h2.shape
    np.testing.assert_allclose(h2, h1, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u1),
                               rtol=1e-10, atol=1e-14)


def test_chunked_matches_periter_flow_only():
    sim = _tiny_sim(turbulent=False)
    assert not sim.turbulent
    u1, t1, h1 = sim.run(niter=7, quiet=True)
    u2, t2, h2 = sim.run(niter=7, quiet=True, chunk=3)
    assert h1.shape == h2.shape
    np.testing.assert_allclose(h2, h1, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u1),
                               rtol=1e-10, atol=1e-14)


def test_chunked_history_numbering(tmp_path):
    """Iteration column in history.dat stays absolute (0..6) across the
    2 full chunks + 1-iteration per-iteration remainder."""
    sim = _tiny_sim(turbulent=True)
    sim.enable_output(str(tmp_path))
    sim.run(niter=7, quiet=True, chunk=3)
    lines = [ln for ln in open(os.path.join(tmp_path, "history.dat"))
             if ln and ln[0] in "0123456789 "]
    rows = [ln.split(",") for ln in lines if "," in ln]
    iters = [int(float(r[0])) for r in rows]
    assert iters == list(range(7)), iters
