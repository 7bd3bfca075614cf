"""The in-repo stand-in for the flagship combustor (su2_tpu/testcase.py):
its library, mesh and cfg go through the normal readers and keep the
flagship's shapes."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from su2_tpu import testcase
from su2_tpu.chemistry import library as cl
from su2_tpu.config import Config
from su2_tpu.io import tables


def test_library_keeps_flagship_shapes(standin_dir):
    files = tables.read_manifest(os.path.join(standin_dir, "library.txt"))
    assert files.mixture.species == list(testcase.SPECIES_ORDER)
    assert len(files.mixture.species) == 9
    chem = files.chemistry
    assert chem.nreactions == 2
    # one irreversible C4H6 oxidation, one reversible CO/CO2 with an
    # explicit backward rate (the shipped topology)
    assert not chem.reversible[0] and not chem.has_backward[0]
    assert chem.reversible[1] and chem.has_backward[1]
    sp = {s: i for i, s in enumerate(files.mixture.species)}
    assert chem.stoich_r[sp["C4H6"], 0] == 1.0
    assert chem.stoich_p[sp["CO2"], 1] == 1.0
    # every species table on the shared grid
    for tab in files.thermo + files.transport:
        np.testing.assert_array_equal(tab.temps, testcase.T_GRID)
    assert len(testcase.ASSUMED) > 0


def test_thermo_tables_follow_constant_cp(standin_lib):
    """h and cp tables are the JANAF 298.15 K values at constant cp."""
    t = jnp.asarray([298.15, 1000.0, 2500.0])
    cp = np.asarray(cl.species_cp(standin_lib, t))
    h = np.asarray(cl.species_enthalpy(standin_lib, t))
    for k, name in enumerate(testcase.SPECIES_ORDER):
        mm, hf, _s, cp_mol, _dv = testcase.SPECIES[name]
        np.testing.assert_allclose(cp[:, k], cp_mol * 1e3 / mm, rtol=1e-12)
        np.testing.assert_allclose(h[0, k], hf * 1e6 / mm,
                                   rtol=1e-9, atol=1e-6)


def test_mixture_inert_at_inlet_temperature(standin_lib):
    """At the 300 K inlet temperature both reactions are frozen, as the
    flagship is before ignition, and they run at flame temperatures."""
    ys = np.zeros((2, 9))
    sp = {s: i for i, s in enumerate(testcase.SPECIES_ORDER)}
    ys[:, sp["C4H6"]] = 0.1
    ys[:, sp["CO"]] = 0.1
    ys[:, sp["O2"]] = 0.8
    rf, rb, _ = cl.reaction_rates(standin_lib, jnp.asarray([300.0, 2500.0]),
                                  jnp.asarray([1.0, 0.2]), jnp.asarray(ys))
    rf = np.asarray(rf)
    assert (rf[1] > 1e3).all()
    assert (rf[0] < 1e-15 * rf[1]).all()


@pytest.mark.parametrize("species", [("O2",), ("O2", "H2O", "CO2")])
def test_species_subset_is_inert(tmp_path, species):
    lib = cl.load_library(testcase.write_library(str(tmp_path), species))
    assert lib.nspecies == len(species) and lib.nreactions == 0
    assert lib.species == tuple(species)


def test_graded_channel_seeded(tmp_path):
    a = testcase.graded_channel(21, 11, seed=0)
    b = testcase.graded_channel(21, 11, seed=0)
    c = testcase.graded_channel(21, 11, seed=1)
    flat = testcase.graded_channel(21, 11, seed=None)
    np.testing.assert_array_equal(a.coords, b.coords)
    assert not np.array_equal(a.coords, c.coords)
    # boundary nodes are not jittered: markers keep straight walls
    np.testing.assert_array_equal(a.coords[:11], flat.coords[:11])
    y = flat.coords[:11, 1]
    assert y[0] == 0.0 and y[-1] == pytest.approx(testcase.LY)
    # wall grading: the first cell is thinner than the central one
    dy = np.diff(y)
    assert dy[0] < dy[len(dy) // 2]
    assert set(a.markers) == {"inlet", "outlet", "lower_wall", "upper_wall"}


def test_cfg_has_flagship_physics(standin_dir):
    cfg = Config(os.path.join(standin_dir, "case.cfg"))
    assert cfg.reactive and cfg.viscous and cfg.turbulent
    assert cfg.kind_turb_model == "SST"
    assert cfg.pasr_lb == pytest.approx(0.2)
    assert cfg.nspecies == 9
    assert cfg.implicit_turb and not cfg.implicit_flow
    assert cfg.linear_solver_prec == "LU_SGS"
    assert cfg.num_method_grad == "WEIGHTED_LEAST_SQUARES"
    # no cold-start pressure transient: freestream at the outlet pressure
    assert cfg.freestream_pressure == pytest.approx(101325.0)
    assert cfg.marker_outlet["outlet"] == pytest.approx(101325.0)


def test_mixture_states_are_consistent(standin_lib):
    """The seeded kernel-check states solve back to their temperature."""
    from su2_tpu import state as st
    lay = st.Layout(2, 9)
    u, tg, tke = testcase.mixture_states(standin_lib, lay, 64, seed=3)
    _, v, nonphys = st.cons2prim(standin_lib, lay, jnp.asarray(u),
                                 jnp.asarray(tg), st.TSolveParams(),
                                 turb_ke=jnp.asarray(tke))
    assert not np.asarray(nonphys).any()
    t = v[:, lay.T]
    ys = v[:, lay.YS:]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    e = (cl.mixture_enthalpy(standin_lib, t, ys)
         - cl.mixture_rgas(standin_lib, ys) * t
         + 0.5 * jnp.sum(vel * vel, axis=1) + jnp.asarray(tke))
    np.testing.assert_allclose(np.asarray(e), u[:, lay.RHOE] / u[:, lay.RHO],
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(ys).sum(1), 1.0, rtol=1e-12)


def test_cfg_feeds_inert_premix(standin_dir, standin_lib):
    """The channel starts with a lean C4H6/O2 premix and is fed a richer
    one: two live species rows and an inlet composition gradient, both
    frozen at the 300 K inlet temperature."""
    cfg = Config(os.path.join(standin_dir, "case.cfg"))
    sp = {s: i for i, s in enumerate(testcase.SPECIES_ORDER)}
    fill = np.asarray(cfg.freestream_mass_frac)
    inlet = np.asarray(cfg.inlet_mass_frac["inlet"])
    for ys, mix in ((fill, testcase.FILL_MIX), (inlet, testcase.INLET_MIX)):
        assert ys.sum() == pytest.approx(1.0)
        assert set(np.flatnonzero(ys)) == {sp["C4H6"], sp["O2"]}
        for name, y in mix.items():
            assert ys[sp[name]] == pytest.approx(y)
    assert inlet[sp["C4H6"]] > fill[sp["C4H6"]]
    rf, _, _ = cl.reaction_rates(standin_lib, jnp.asarray([300.0, 2500.0]),
                                 jnp.asarray([1.2, 0.2]),
                                 jnp.asarray([inlet, inlet]))
    rf = np.asarray(rf)
    assert rf[0, 0] < 1e-15 * rf[1, 0]
