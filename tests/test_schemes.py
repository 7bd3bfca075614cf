"""Centered (JST / Lax-Friedrichs) and HLLC scheme tests.

Reference behavior: CCentJST_Flow / CCentLax_Flow / CUpwHLLC_Flow
(numerics_direct_mean.cpp) on the standard ideal-gas solver path.
"""

import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from su2_tpu.chemistry import library as cl
from su2_tpu.state import Layout

GAMMA = 1.4
RGAS = 287.058


@pytest.fixture(scope="module")
def lib():
    return cl.ideal_gas_library(gamma=GAMMA, r_gas=RGAS)


def _prim_row(lay, t, vel, p):
    rho = p / (RGAS * t)
    a = np.sqrt(GAMMA * RGAS * t)
    cp = GAMMA / (GAMMA - 1.0) * RGAS
    h = cp * t + 0.5 * np.sum(np.asarray(vel) ** 2)
    row = np.zeros(lay.nprim)
    row[lay.T] = t
    row[lay.VX:lay.VX + lay.ndim] = vel
    row[lay.P] = p
    row[lay.PRHO] = rho
    row[lay.H] = h
    row[lay.A] = a
    row[lay.YS] = 1.0
    return row


def _exact_flux(lay, row, normal):
    rho, p, h = row[lay.PRHO], row[lay.P], row[lay.H]
    vel = row[lay.VX:lay.VX + lay.ndim]
    qn = float(np.dot(vel, normal))
    f = np.zeros(lay.nvar)
    f[lay.RHO] = rho * qn
    f[lay.RHOVX:lay.RHOVX + lay.ndim] = rho * vel * qn + p * np.asarray(normal)
    f[lay.RHOE] = rho * h * qn
    f[lay.RHOS] = rho * qn
    return f


def test_hllc_consistency_and_upwinding():
    from su2_tpu.ops import hllc

    lay = Layout(2, 1)
    normal = np.array([[0.6, 0.8], [0.6, 0.8], [0.6, 0.8]]) * 2.0  # area 2
    # face 0: identical states; face 1: supersonic left-to-right;
    # face 2: supersonic right-to-left
    sub = _prim_row(lay, 300.0, [50.0, 10.0], 101325.0)
    sup = _prim_row(lay, 300.0, [600.0, 0.0], 101325.0)
    sup_back = _prim_row(lay, 300.0, [-600.0, 0.0], 101325.0)
    v_i = jnp.asarray([sub, sup, sup_back])
    v_j = jnp.asarray([sub, sup * 1.0, sup_back])
    v_j = v_j.at[1].set(jnp.asarray(_prim_row(lay, 290.0, [580.0, 0.0], 98000.0)))
    v_j = v_j.at[2].set(jnp.asarray(_prim_row(lay, 290.0, [-580.0, 0.0], 98000.0)))
    flux = np.asarray(hllc.hllc_flux(lay, v_i, v_j, jnp.asarray(normal)))

    # consistency: F(v, v) == exact projected flux
    np.testing.assert_allclose(flux[0], _exact_flux(lay, sub, normal[0]),
                               rtol=1e-12)
    # supersonic downwind: pure left flux
    np.testing.assert_allclose(flux[1], _exact_flux(lay, sup, normal[1]),
                               rtol=1e-12)
    # supersonic upwind: pure right flux
    np.testing.assert_allclose(
        flux[2],
        _exact_flux(lay, np.asarray(v_j[2]), normal[2]), rtol=1e-12)


def test_inviscid_proj_jac_matches_ideal_gas_form():
    """The generalized A(U).n must reduce to the textbook gamma form."""
    from su2_tpu.ops import centered

    lay = Layout(2, 1)
    row = _prim_row(lay, 350.0, [120.0, -40.0], 90000.0)
    normal = np.array([0.3, 1.1])
    u, v_ = row[lay.VX], row[lay.VX + 1]
    qn = u * normal[0] + v_ * normal[1]
    h = row[lay.H]
    g1 = GAMMA - 1.0
    phi = 0.5 * g1 * (u * u + v_ * v_)
    # dP/dU row for the perfect gas
    s = np.zeros(lay.nvar)
    s[lay.RHO] = phi
    s[lay.RHOVX] = -g1 * u
    s[lay.RHOVX + 1] = -g1 * v_
    s[lay.RHOE] = g1
    s[lay.RHOS] = RGAS * 350.0 - g1 * (h - row[lay.P] / row[lay.PRHO]
                                       - 0.5 * (u * u + v_ * v_))
    jac = np.asarray(centered.inviscid_proj_jac(
        lay, jnp.asarray(row)[None], jnp.asarray(s)[None],
        jnp.asarray(normal)[None]))[0]

    # textbook 4x4 block (rho, rho u, rho v, rho E) for the perfect gas
    a = np.zeros((4, 4))
    a[0] = [0.0, normal[0], normal[1], 0.0]
    a[1] = [phi * normal[0] - u * qn,
            qn - (GAMMA - 2.0) * u * normal[0],
            u * normal[1] - g1 * v_ * normal[0], g1 * normal[0]]
    a[2] = [phi * normal[1] - v_ * qn,
            v_ * normal[0] - g1 * u * normal[1],
            qn - (GAMMA - 2.0) * v_ * normal[1], g1 * normal[1]]
    a[3] = [(phi - h) * qn, h * normal[0] - g1 * u * qn,
            h * normal[1] - g1 * v_ * qn, GAMMA * qn]
    rows = [lay.RHO, lay.RHOVX, lay.RHOVX + 1, lay.RHOE]
    np.testing.assert_allclose(jac[np.ix_(rows, rows)], a, rtol=1e-10,
                               atol=1e-8)


CFG_TMPL = """
    PHYSICAL_PROBLEM= EULER
    MACH_NUMBER= 0.4
    AOA= 0.0
    FREESTREAM_PRESSURE= 101325.0
    FREESTREAM_TEMPERATURE= 288.15
    MARKER_FAR= ( inlet, outlet, lower_wall, upper_wall )
    NUM_METHOD_GRAD= GREEN_GAUSS
    CFL_NUMBER= 4.0
    CONV_NUM_METHOD_FLOW= {scheme}
    TIME_DISCRE_FLOW= EULER_IMPLICIT
    LINEAR_SOLVER= FGMRES
    LINEAR_SOLVER_ITER= 5
    MESH_FILENAME= unused.su2
"""


@pytest.mark.parametrize("scheme", ["JST", "LAX-FRIEDRICH", "HLLC"])
def test_freestream_preserved(tmp_path, scheme):
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation
    from su2_tpu.geometry.structured import channel_mesh

    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(textwrap.dedent(CFG_TMPL.format(scheme=scheme)))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(9, 7, lx=1.0, ly=0.5))
        _, _, hist = sim.run(2, quiet=True)
    finally:
        os.chdir(cwd)
    assert hist[-1][sim.lay.RHO] < -10.0, hist[-1]


def test_jst_converges_channel(tmp_path):
    """JST implicit must reduce the residual on a disturbed channel flow."""
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation
    from su2_tpu.geometry.structured import channel_mesh

    cfg = textwrap.dedent("""
        PHYSICAL_PROBLEM= EULER
        MACH_NUMBER= 0.3
        FREESTREAM_PRESSURE= 101325.0
        FREESTREAM_TEMPERATURE= 288.15
        MARKER_EULER= ( lower_wall, upper_wall )
        MARKER_INLET= ( inlet, 293.3, 107800.0, 1.0, 0.0, 0.0 )
        MARKER_OUTLET= ( outlet, 101325.0 )
        INLET_TYPE= TOTAL_CONDITIONS
        NUM_METHOD_GRAD= GREEN_GAUSS
        CFL_NUMBER= 4.0
        CONV_NUM_METHOD_FLOW= JST
        TIME_DISCRE_FLOW= EULER_IMPLICIT
        LINEAR_SOLVER= FGMRES
        LINEAR_SOLVER_ITER= 8
        MESH_FILENAME= unused.su2
    """)
    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(cfg)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(13, 9, lx=1.0, ly=0.4))
        _, _, hist = sim.run(30, quiet=True)
    finally:
        os.chdir(cwd)
    assert hist[-1][sim.lay.RHO] < hist[0][sim.lay.RHO] - 0.5, \
        (hist[0][sim.lay.RHO], hist[-1][sim.lay.RHO])


def test_cfl_adaption(tmp_path):
    """CFL_ADAPT ramps the CFL as the residual falls (SetCFL_Number,
    output_structure.cpp:5975) without breaking convergence."""
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation
    from su2_tpu.geometry.structured import channel_mesh

    cfg = textwrap.dedent("""
        PHYSICAL_PROBLEM= EULER
        MACH_NUMBER= 0.3
        FREESTREAM_PRESSURE= 101325.0
        FREESTREAM_TEMPERATURE= 288.15
        MARKER_EULER= ( lower_wall, upper_wall )
        MARKER_INLET= ( inlet, 293.3, 107800.0, 1.0, 0.0, 0.0 )
        MARKER_OUTLET= ( outlet, 101325.0 )
        INLET_TYPE= TOTAL_CONDITIONS
        NUM_METHOD_GRAD= GREEN_GAUSS
        CFL_NUMBER= 2.0
        CFL_ADAPT= YES
        CFL_ADAPT_PARAM= ( 1.5, 0.5, 1.25, 50.0 )
        CONV_NUM_METHOD_FLOW= AUSM
        SPATIAL_ORDER_FLOW= 1ST_ORDER
        TIME_DISCRE_FLOW= EULER_IMPLICIT
        LINEAR_SOLVER= FGMRES
        LINEAR_SOLVER_ITER= 8
        MESH_FILENAME= unused.su2
    """)
    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(cfg)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(13, 9, lx=1.0, ly=0.4))
        _, _, hist = sim.run(40, quiet=True)
    finally:
        os.chdir(cwd)
    assert np.isfinite(hist).all()
    assert hist[-1][sim.lay.RHO] < hist[0][sim.lay.RHO] - 0.5
    assert sim.cfl_now != 2.0            # the CFL actually adapted
    assert 1.25 <= sim.cfl_now <= 50.0


def test_rk_explicit_converges(tmp_path):
    """3-stage RK explicit (ExplicitRK_Iteration) reduces the residual and
    preserves freestream exactly."""
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation
    from su2_tpu.geometry.structured import channel_mesh

    cfg = textwrap.dedent("""
        PHYSICAL_PROBLEM= EULER
        MACH_NUMBER= 0.3
        FREESTREAM_PRESSURE= 101325.0
        FREESTREAM_TEMPERATURE= 288.15
        MARKER_EULER= ( lower_wall, upper_wall )
        MARKER_INLET= ( inlet, 293.3, 107800.0, 1.0, 0.0, 0.0 )
        MARKER_OUTLET= ( outlet, 101325.0 )
        INLET_TYPE= TOTAL_CONDITIONS
        NUM_METHOD_GRAD= GREEN_GAUSS
        CFL_NUMBER= 1.2
        CONV_NUM_METHOD_FLOW= AUSM
        SPATIAL_ORDER_FLOW= 1ST_ORDER
        TIME_DISCRE_FLOW= RUNGE-KUTTA_EXPLICIT
        RK_ALPHA_COEFF= ( 0.66667, 0.66667, 1.0 )
        MESH_FILENAME= unused.su2
    """)
    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(cfg)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(13, 9, lx=1.0, ly=0.4))
        _, _, hist = sim.run(250, quiet=True)
    finally:
        os.chdir(cwd)
    assert np.isfinite(hist).all()
    # explicit RK at CFL ~1 converges slowly; ~1 order in 250 iters is the
    # expected single-grid rate on this mesh
    assert hist[-1][sim.lay.RHO] < hist[0][sim.lay.RHO] - 0.8, \
        (hist[0][sim.lay.RHO], hist[-1][sim.lay.RHO])


def test_mass_flow_inlet_converges(tmp_path):
    """INLET_TYPE= MASS_FLOW (density + velocity imposed, pressure
    extrapolated — BC_Inlet MASS_FLOW branch)."""
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation
    from su2_tpu.geometry.structured import channel_mesh

    cfg = textwrap.dedent("""
        PHYSICAL_PROBLEM= EULER
        MACH_NUMBER= 0.3
        FREESTREAM_PRESSURE= 101325.0
        FREESTREAM_TEMPERATURE= 288.15
        MARKER_EULER= ( lower_wall, upper_wall )
        MARKER_INLET= ( inlet, 1.3, 80.0, 1.0, 0.0, 0.0 )
        MARKER_OUTLET= ( outlet, 101325.0 )
        INLET_TYPE= MASS_FLOW
        CFL_NUMBER= 5.0
        SPATIAL_ORDER_FLOW= 1ST_ORDER
        TIME_DISCRE_FLOW= EULER_IMPLICIT
        LINEAR_SOLVER_ITER= 6
        MESH_FILENAME= unused.su2
    """)
    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(cfg)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(13, 9, lx=1.0, ly=0.4))
        u, t, hist = sim.run(400, quiet=True)
    finally:
        os.chdir(cwd)
    assert np.isfinite(hist).all()
    # steady convergence (slow acoustic adjustment at this CFL): ~1.5 orders
    assert hist[-1][sim.lay.RHO] < hist[0][sim.lay.RHO] - 1.4
    # inlet density imposed: rho at the inlet column approaches 1.3
    nodes = np.asarray(sim.grid.bnd_nodes["inlet"])
    rho_in = np.asarray(u[nodes, sim.lay.RHO])
    assert abs(rho_in.mean() - 1.3) < 0.05, rho_in.mean()


