import numpy as np
import jax
import jax.numpy as jnp
import pytest

from su2_tpu.parallel import partition, sharding


def test_rcb_balance_and_perm():
    rng = np.random.default_rng(0)
    coords = rng.normal(0, 1, (1000, 2))
    perm = partition.rcb_order(coords, 8)
    assert sorted(perm.tolist()) == list(range(1000))
    sizes = partition.partition_counts(1000, 8)
    assert sizes.sum() == 1000 and sizes.max() - sizes.min() <= 1


def test_multichip_matches_single_device():
    """One coupled RANS step on a tiny channel: 8 virtual devices vs 1."""
    import __graft_entry__ as g

    sim1 = g._flagship_sim(jnp.float64, tiny=True)
    q0 = sim1.initial_turb_state()
    out1 = sim1._step(sim1.u0, sim1.t0, *q0, jnp.asarray(False))
    u1 = np.asarray(out1[0])

    sim8 = g._flagship_sim(jnp.float64, ndevices=8, tiny=True)
    q8 = sim8.initial_turb_state()
    out8 = sim8._step(sim8.u0, sim8.t0, *q8, jnp.asarray(False))
    u8 = np.asarray(out8[0])

    n_real = u1.shape[0]
    # sim8's nodes are RCB-permuted: u8[k] corresponds to u1[perm[k]]
    np.testing.assert_allclose(u8[:n_real], u1[sim8.perm], rtol=1e-10,
                               atol=1e-10 * np.abs(u1).max())


def test_multichip_real_combustion_case(combustion_dir):
    """8 virtual devices vs 1 on the SHIPPED combustion mesh (9000 nodes,
    pads to 9008): regression pin for the pad-row NaN bug — coincident
    dummy-node coordinates made the viscous edge-projection divide 0/0 on
    dummy edges, and the pad NaNs spread into real rows through 0*NaN in
    the roll-based stencil sweeps.  Both sims renumber into the same
    structured order, so rows compare directly."""
    import os
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation

    cfg = Config(os.path.join(combustion_dir, "my_combustion_no_chem.cfg"))
    sim1 = Simulation(cfg, dtype=jnp.float64)
    sim8 = Simulation(cfg, dtype=jnp.float64, ndevices=8)
    assert sim8.mesh.n_shards == 8
    q1 = sim1.initial_turb_state()
    q8 = sim8.initial_turb_state()
    o1 = sim1._step(sim1.u0, sim1.t0, *q1, jnp.asarray(False))
    o8 = sim8._step(sim8.u0, sim8.t0, *q8, jnp.asarray(False))
    u1, u8 = np.asarray(o1[0]), np.asarray(o8[0])
    q1n, q8n = np.asarray(o1[2]), np.asarray(o8[2])
    n = u1.shape[0]
    assert not np.isnan(u8).any() and not np.isnan(q8n).any()
    # reported RMS residuals match too — regression pin for the pad-row
    # turb-source bug (unit-volume dummy nodes with nonzero wall distance
    # fired the SST source and inflated the 8-dev turb RMS by 4 orders)
    np.testing.assert_allclose(np.asarray(o8[6]), np.asarray(o1[6]),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(o8[8]), np.asarray(o1[8]),
                               rtol=1e-9)
    sc = np.abs(u1).max(axis=0)
    sc[sc == 0] = 1.0
    np.testing.assert_array_less(
        np.abs(u8[:n] - u1) / sc[None, :], 1e-9)
    scq = np.abs(q1n).max(axis=0)
    np.testing.assert_array_less(
        np.abs(q8n[:n] - q1n) / scq[None, :], 1e-12)


def test_sharded_step_uses_neighbor_collectives():
    """Structured-band sharding: the coupled step's neighbor traffic rides
    collective-permutes (roll slab exchanges — the ppermute halo of SURVEY
    §2.3), not full-field all-gathers; the boundary section is shard-local
    (solvers/bc_dense.py), so it adds none either."""
    import re
    import __graft_entry__ as g

    sim8 = g._flagship_sim(jnp.float64, ndevices=8, tiny=True)
    assert sim8.mesh.n_shards == 8
    assert sim8.mesh.stencil_offsets is not None   # structured path engaged
    q8 = sim8.initial_turb_state()
    step = sim8._make_rans_step()
    txt = jax.jit(step).lower(sim8.u0, sim8.t0, *q8,
                              jnp.asarray(False)).compile().as_text()
    n_cp = len(re.findall(r"\bcollective-permute\b", txt))
    # ZERO all-gathers of ANY shape: interior neighbor traffic rides
    # collective-permutes and the BC section is the dense shard-local path
    # (solvers/bc_dense.py) — the 22 marker-scale all-gathers of the
    # replicated-marker-batch path are gone (VERDICT round-2 item 3)
    ags = re.findall(r"all-gather(?:-start)?\(", txt)
    assert n_cp > 0, "no collective-permutes: halo exchange path not engaged"
    assert len(ags) == 0, f"{len(ags)} all-gathers in sharded step HLO"


def test_sharded_mesh_args_multistep_matches_constant_closure(
        standin_dir, monkeypatch):
    """The mesh-as-arguments tier composes with sharding —
    SU2_TPU_MESH_ARGS=1 on an 8-device sim of the stand-in must match the
    sharded constant-closure multistep (the buffers are committed with
    NamedShardings, so jit infers in_shardings and GSPMD partitions the
    traced rolls identically)."""
    import os
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation

    cfg = Config(os.path.join(standin_dir, "case.cfg"))

    def run(mode):
        monkeypatch.setenv("SU2_TPU_MESH_ARGS", mode)
        sim = Simulation(cfg, dtype=jnp.float64, ndevices=8)
        q = sim.initial_turb_state()
        ig = jnp.zeros((2,), bool)
        carry, ys = sim.rans_multistep(sim.u0, sim.t0, *q, ig)
        assert sim._multistep_args == (mode == "1")
        return np.asarray(carry[0]), np.asarray(ys[0])

    u_c, rms_c = run("0")
    u_a, rms_a = run("1")
    sc = np.abs(u_c).max(axis=0)
    sc[sc == 0] = 1.0
    # f64 path: the two program forms differ only in constant folding
    assert (np.abs(u_a - u_c) / sc[None, :]).max() < 1e-9
    assert np.abs(rms_a - rms_c).max() < 1e-9




def test_multichip_standin_case(standin_dir):
    """8 virtual devices vs 1 on the stand-in combustor (561 nodes, padded
    to 568): the pad rows stay finite and the real rows match."""
    import os
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation

    cfg = Config(os.path.join(standin_dir, "case.cfg"))
    sim1 = Simulation(cfg, dtype=jnp.float64)
    sim8 = Simulation(cfg, dtype=jnp.float64, ndevices=8)
    assert sim8.mesh.n_shards == 8 and sim8.mesh.npoint > sim1.mesh.npoint
    o1 = sim1._step(sim1.u0, sim1.t0, *sim1.initial_turb_state(),
                    jnp.asarray(False))
    o8 = sim8._step(sim8.u0, sim8.t0, *sim8.initial_turb_state(),
                    jnp.asarray(False))
    u1 = sim1.to_file_order(o1[0])
    u8 = sim8.to_file_order(o8[0])
    assert np.isfinite(np.asarray(o8[0])).all()
    sc = np.abs(u1).max(axis=0)
    lay = sim1.lay
    sc[lay.RHOVX:lay.RHOVX + lay.ndim] = sc[lay.RHOVX:lay.RHOVX
                                            + lay.ndim].max()
    sc[sc == 0] = 1.0
    np.testing.assert_array_less(np.abs(u8 - u1) / sc[None, :], 1e-10)
    # residual RMS rows: the transverse-momentum row is at roundoff level
    r1, r8 = np.asarray(o1[6]), np.asarray(o8[6])
    np.testing.assert_allclose(r8, r1, rtol=1e-9, atol=1e-12 * r1.max())
