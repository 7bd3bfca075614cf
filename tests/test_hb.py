"""Harmonic-balance (time-spectral) driver tests (CHBDriver parity)."""

import os
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp

from su2_tpu import hb
from su2_tpu.config import Config
from su2_tpu.driver import Simulation
from su2_tpu.geometry.structured import channel_mesh


def test_hb_operator_is_spectrally_exact():
    """D applied to samples of sin/cos at the collocation times equals the
    exact time derivative (the pseudo-spectral property the reference's
    ComputeHB_Operator provides)."""
    period = 0.8
    n = 5
    om = hb.default_omegas(period, n)
    d = hb.hb_operator(period, om, n)
    t = np.arange(n) * period / n
    w0 = 2.0 * np.pi / period
    for f, df in [(np.sin(w0 * t), w0 * np.cos(w0 * t)),
                  (np.cos(2 * w0 * t), -2 * w0 * np.sin(2 * w0 * t)),
                  (np.ones_like(t), np.zeros_like(t))]:
        np.testing.assert_allclose(d @ f, df, atol=1e-9 * max(1.0, w0 * 2))


CFG = textwrap.dedent("""
    PHYSICAL_PROBLEM= EULER
    MACH_NUMBER= 0.3
    FREESTREAM_TEMPERATURE= 288.15
    FREESTREAM_PRESSURE= 101325.0
    MARKER_FAR= ( lower_wall, upper_wall, inlet, outlet )
    CFL_NUMBER= 0.8
    CONV_NUM_METHOD_FLOW= ROE
    TIME_DISCRE_FLOW= EULER_EXPLICIT
    SPATIAL_ORDER_FLOW= 1ST_ORDER
    NUM_METHOD_GRAD= GREEN_GAUSS
    GRID_MOVEMENT= YES
    GRID_MOVEMENT_KIND= RIGID_MOTION
    PITCHING_OMEGA_Z= 62.8318530718
    PITCHING_AMPL_Z= 1.0
    MOTION_ORIGIN_X= 0.5
    MESH_FILENAME= unused.su2
""")


def test_hb_preserves_freestream_under_pitching(tmp_path):
    """Uniform freestream with far-field everywhere is an exact solution of
    the HB system for a rigidly pitching mesh: each instance's ALE residual
    vanishes and the spectral source of an instance-constant state is zero
    (sum_j D_ij = 0).  Joint exactness test of the operator + ALE fluxes."""
    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(CFG)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(13, 9, lx=1.0, ly=0.4))
    finally:
        os.chdir(cwd)
    period = 2.0 * np.pi / 62.8318530718
    drv = hb.HBDriver(sim, n_inst=3, period=period)
    u0 = np.asarray(sim.u0)
    u_all, t_all, hist = drv.run(20, quiet=True)
    ua = np.asarray(u_all)
    for i in range(3):
        rel = np.abs(ua[i] - u0).max() / np.abs(u0).max()
        assert rel < 1e-12, (i, rel)


def test_hb_single_instance_matches_steady(tmp_path):
    """N=1, Omega=(0,): D == 0 and the HB driver reduces to the steady
    solver — the channel inlet/outlet transient must match Simulation.run's
    trajectory closely (same physics, remesh-evaluated metrics)."""
    cfg_text = textwrap.dedent("""
        PHYSICAL_PROBLEM= EULER
        MACH_NUMBER= 0.3
        FREESTREAM_TEMPERATURE= 288.15
        FREESTREAM_PRESSURE= 101325.0
        MARKER_EULER= ( lower_wall, upper_wall )
        MARKER_INLET= ( inlet, 293.3, 107800.0, 1.0, 0.0, 0.0 )
        MARKER_OUTLET= ( outlet, 101325.0 )
        INLET_TYPE= TOTAL_CONDITIONS
        CFL_NUMBER= 0.8
        CONV_NUM_METHOD_FLOW= ROE
        TIME_DISCRE_FLOW= EULER_EXPLICIT
        SPATIAL_ORDER_FLOW= 1ST_ORDER
        NUM_METHOD_GRAD= GREEN_GAUSS
        MESH_FILENAME= unused.su2
    """)
    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(cfg_text)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(13, 9, lx=1.0, ly=0.4))
    finally:
        os.chdir(cwd)
    drv = hb.HBDriver(sim, n_inst=1, period=1.0, omegas=[0.0])
    assert np.abs(np.asarray(drv.d_op)).max() == 0.0
    u_all, _, _ = drv.run(60, quiet=True)
    u_ref, _, _ = sim.run(60, quiet=True)
    ua = np.asarray(u_all)[0]
    ur = np.asarray(u_ref)
    rel = np.abs(ua - ur).max() / np.abs(ur).max()
    # same equations; metrics evaluated by remesh vs the host builder agree
    # to rounding
    assert rel < 1e-9, rel


def _build(tmp_path, cfg_text, raw):
    cfg_path = tmp_path / "case.cfg"
    cfg_path.write_text(cfg_text)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return Simulation(Config(str(cfg_path)), raw_mesh=raw)
    finally:
        os.chdir(cwd)


CFG_IMPL = textwrap.dedent("""
    PHYSICAL_PROBLEM= EULER
    MACH_NUMBER= 0.3
    FREESTREAM_TEMPERATURE= 288.15
    FREESTREAM_PRESSURE= 101325.0
    MARKER_EULER= ( lower_wall, upper_wall )
    MARKER_INLET= ( inlet, 293.3, 107800.0, 1.0, 0.0, 0.0 )
    MARKER_OUTLET= ( outlet, 101325.0 )
    INLET_TYPE= TOTAL_CONDITIONS
    CFL_NUMBER= 10.0
    CONV_NUM_METHOD_FLOW= AUSM
    TIME_DISCRE_FLOW= EULER_IMPLICIT
    LINEAR_SOLVER= FGMRES
    LINEAR_SOLVER_PREC= LU_SGS
    LINEAR_SOLVER_ITER= 8
    LINEAR_SOLVER_ERROR= 1e-6
    SPATIAL_ORDER_FLOW= 1ST_ORDER
    NUM_METHOD_GRAD= GREEN_GAUSS
    MESH_FILENAME= unused.su2
""")


def test_hb_implicit_single_instance_matches_steady(tmp_path):
    """Implicit HB (round 4) with N=1, Omega=(0,): D == 0 and the
    vmapped implicit instance update must reproduce the production
    implicit trajectory (same physics; edge-layout solver ops instead of
    the family fast path, so agreement is to roundoff)."""
    sim = _build(tmp_path, CFG_IMPL, channel_mesh(13, 9, lx=1.0, ly=0.4))
    drv = hb.HBDriver(sim, n_inst=1, period=1.0, omegas=[0.0])
    assert drv.implicit
    u_all, _, _ = drv.run(40, quiet=True)
    u_ref, _, _ = sim.run(40, quiet=True)
    ua = np.asarray(u_all)[0]
    ur = np.asarray(u_ref)
    rel = np.abs(ua - ur).max() / np.abs(ur).max()
    # the HB instance update strips the family fast paths (edge
    # layout under vmap), so the UNDER-CONVERGED inner FGMRES iterates
    # differ in summation order from the production path; 40 implicit
    # steps accumulate ~5e-6 relative (observed) — gate with margin
    assert rel < 5e-5, rel


CFG_RANS_HB = textwrap.dedent("""
    CONFIG_LIB_FILE = test_air.txt
    FREESTREAM_MASS_FRAC = (0.2197, 0.0302, 0.7501)
    SPECIES_ORDER = (O2, CO2, N2)
    PHYSICAL_PROBLEM= REACTIVE_NAVIER_STOKES
    KIND_TURB_MODEL= SST
    MACH_NUMBER= 0.2
    FREESTREAM_TEMPERATURE= 297.62
    FREESTREAM_VELOCITY= (69.1687, 0.0, 0.0)
    FREESTREAM_PRESSURE= 113303.0
    REYNOLDS_LENGTH= 1.0
    REYNOLDS_NUMBER= 50000
    FREESTREAM_TURBULENCEINTENSITY = 0.05
    FREESTREAM_TURB2LAMVISCRATIO = 10.0
    MARKER_HEATFLUX = (lower_wall, 0.0)
    MARKER_EULER= ( upper_wall )
    MARKER_INLET= ( inlet, 300.0, 120000.0, 1.0, 0.0, 0.0 )
    INLET_MASS_FRAC = (inlet, 0.2197, 0.0302, 0.7501)
    MARKER_OUTLET= ( outlet, 113303.0 )
    NUM_METHOD_GRAD= GREEN_GAUSS
    CFL_NUMBER= 4.0
    LINEAR_SOLVER= FGMRES
    LINEAR_SOLVER_PREC= LU_SGS
    LINEAR_SOLVER_ERROR= 1E-10
    LINEAR_SOLVER_ITER= 20
    CONV_NUM_METHOD_FLOW= AUSM
    SPATIAL_ORDER_FLOW= 1ST_ORDER
    TIME_DISCRE_FLOW= EULER_IMPLICIT
    CONV_NUM_METHOD_TURB= SCALAR_UPWIND
    TIME_DISCRE_TURB= EULER_IMPLICIT
    MESH_FILENAME= unused.su2
""")


@pytest.mark.slow
def test_hb_implicit_rans_converges(tmp_path):
    """Implicit HB on the full turbulent (SST) viscous path: N=3 on a
    steady RANS channel (all omegas 0 is degenerate; use the harmonic
    set on a case whose physics is steady so every instance converges to
    the SAME steady state and the spectral source vanishes).  Validates
    the coupled flow+SST instance update with HB sources wired through
    (reference: CHBDriver over the RANS iterate incl. the turbulence
    spectral source, driver_structure.cpp:3950-3984)."""
    flatplate_dir = "/root/reference/Test_Cases/TURBOLENT/TURBOLENT_FLAT_PLATE"
    if not os.path.isdir(flatplate_dir):
        pytest.skip("reference test cases not found")
    cfg_path = tmp_path / "rans.cfg"
    cfg_path.write_text(CFG_RANS_HB)
    cwd = os.getcwd()
    os.chdir(flatplate_dir)
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=channel_mesh(9, 5, lx=1.0, ly=0.4))
    finally:
        os.chdir(cwd)
    # seed from a partially converged steady state (the HB validation
    # targets the coupled instance update, not the startup transient);
    # period chosen so w0*dt ~ 0.08 — the explicit spectral source is
    # stable well below w*dt ~ 1 (hb.py's dt preconditioning note)
    u0, t0, _, turb0 = sim.run(300, quiet=True)
    drv = hb.HBDriver(sim, n_inst=3, period=1e-2)
    assert drv.implicit and drv.turbulent
    import jax.numpy as _jnp
    u_all = _jnp.stack([u0] * 3)
    t_all = _jnp.stack([t0] * 3)
    q_all = _jnp.stack([turb0[0]] * 3)
    r0 = None
    for it in range(200):
        u_all, q_all, t_all, rms = drv._step_implicit(u_all, q_all, t_all)
        if r0 is None:
            r0 = np.asarray(rms)
    ua = np.asarray(u_all)
    qa = np.asarray(q_all)
    assert np.isfinite(ua).all() and np.isfinite(qa).all()
    # steady physics: the three instances must agree (spectral source -> 0)
    for i in (1, 2):
        rel = np.abs(ua[i] - ua[0]).max() / np.abs(ua[0]).max()
        assert rel < 1e-5, (i, rel)
    # and the residual must have dropped substantially
    rn = np.asarray(rms)
    assert rn[sim.lay.RHOVX] < 1e-1 * r0[sim.lay.RHOVX], (r0, rn)


@pytest.mark.slow
def test_hb_pitching_naca_matches_dual_time(tmp_path):
    """Physics cross-validation (round-4 verdict item 4): harmonic balance
    N=3 on the pitching NACA must reproduce the dual-time CL loop — the
    mean, amplitude and phase of the periodic lift — within a few percent
    (reference capability: CHBDriver replacing the dual-time loop,
    driver_structure.cpp:3790-3987)."""
    import textwrap
    from su2_tpu.geometry.structured import naca_omesh
    from su2_tpu import motion as mo

    v_inf = 0.3 * np.sqrt(1.4 * 287.058 * 288.15)
    omega = 0.05 * 2.0 * v_inf          # reduced frequency k = 0.05
    period = 2.0 * np.pi / omega
    nsteps = 24
    base = textwrap.dedent(f"""
        PHYSICAL_PROBLEM= EULER
        MACH_NUMBER= 0.3
        FREESTREAM_TEMPERATURE= 288.15
        FREESTREAM_PRESSURE= 101325.0
        MARKER_EULER= ( airfoil )
        MARKER_FAR= ( farfield )
        MARKER_MONITORING= ( airfoil )
        CFL_NUMBER= 0.9
        CONV_NUM_METHOD_FLOW= ROE
        TIME_DISCRE_FLOW= EULER_EXPLICIT
        SPATIAL_ORDER_FLOW= 1ST_ORDER
        NUM_METHOD_GRAD= GREEN_GAUSS
        GRID_MOVEMENT= YES
        GRID_MOVEMENT_KIND= RIGID_MOTION
        MOTION_ORIGIN_X= 0.25
        PITCHING_OMEGA_Z= {omega}
        PITCHING_AMPL_Z= 2.0
        UNSTEADY_SIMULATION= DUAL_TIME_STEPPING-2ND_ORDER
        UNST_TIMESTEP= {period / nsteps}
        UNST_INT_ITER= 1200
        MESH_FILENAME= unused.su2
    """)
    raw = naca_omesh(n_wrap=49, n_rad=25, radius=8.0)

    def build(extra="", repl=()):
        text = base + extra
        for a, b in repl:
            text = text.replace(a, b)
        p = tmp_path / f"c{abs(hash(text)) % 10**8}.cfg"
        p.write_text(text)
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            return Simulation(Config(str(p)), raw_mesh=raw)
        finally:
            os.chdir(cwd)

    # steady alpha=0 start for the dual-time transient
    static = build(repl=(("TIME_DISCRE_FLOW= EULER_EXPLICIT",
                          """TIME_DISCRE_FLOW= EULER_IMPLICIT
        LINEAR_SOLVER= FGMRES
        LINEAR_SOLVER_PREC= LU_SGS
        LINEAR_SOLVER_ITER= 8
        LINEAR_SOLVER_ERROR= 1e-6"""),
                         ("CFL_NUMBER= 0.9", "CFL_NUMBER= 8.0"),
                         ("GRID_MOVEMENT= YES", "GRID_MOVEMENT= NO")))
    u0, t0, _ = static.run(400, quiet=True, chunk=50)

    # ---- dual-time reference: 2 periods, keep the second ----
    sim_dt = build()
    sim_dt.u0, sim_dt.t0 = u0, t0
    _, _, _, per_step = sim_dt.run_rigid_motion(
        n_steps=2 * nsteps, quiet=True, monitor_tags=("airfoil",))
    cl_dt = np.array([f["CL"] for (_, _, f) in per_step])[nsteps:]
    t_dt = np.array([t for (t, _, _) in per_step])[nsteps:]
    # fit CL ~ a0 + a1 sin(w t) + b1 cos(w t)
    def fit(ts, cls):
        A = np.stack([np.ones_like(ts), np.sin(omega * ts),
                      np.cos(omega * ts)], axis=1)
        return np.linalg.lstsq(A, cls, rcond=None)[0]

    c_dt = fit(t_dt, cl_dt)
    amp_dt = float(np.hypot(c_dt[1], c_dt[2]))
    ph_dt = float(np.arctan2(c_dt[2], c_dt[1]))

    # ---- harmonic balance N=3 (explicit instances, same physics) ----
    sim_hb = build()
    sim_hb.u0, sim_hb.t0 = u0, t0
    drv = hb.HBDriver(sim_hb, n_inst=3, period=period)
    u_all, t_all, _ = drv.run(6000, quiet=True)
    # CL at each instance phase
    from su2_tpu.geometry.diffgeo import build_diffgeo, remesh
    cls_hb = []
    for i, t_i in enumerate(drv.times):
        coords_i = mo.rigid_coords_2d(sim_hb.motion,
                                      sim_hb.mesh.coords, t_i)
        dgeo = build_diffgeo(sim_hb.raw, sim_hb.grid)
        mesh_i = remesh(sim_hb.mesh, dgeo,
                        jnp.asarray(coords_i, sim_hb.dtype))
        saved = sim_hb.mesh
        sim_hb.mesh = mesh_i
        try:
            f = sim_hb.monitor_forces(u_all[i], t_all[i])
        finally:
            sim_hb.mesh = saved
        cls_hb.append(f["CL"])
    c_hb = fit(np.asarray(drv.times), np.array(cls_hb))
    amp_hb = float(np.hypot(c_hb[1], c_hb[2]))
    ph_hb = float(np.arctan2(c_hb[2], c_hb[1]))

    # amplitude within ~10% and phase within ~15 degrees: the dual-time
    # loop carries 2nd-order BDF time error at 24 steps/period while HB
    # is spectrally exact in time — they agree to discretization level
    assert abs(amp_hb - amp_dt) < 0.10 * max(amp_dt, 1e-6), (amp_hb, amp_dt)
    dph = (ph_hb - ph_dt + np.pi) % (2 * np.pi) - np.pi
    assert abs(dph) < np.deg2rad(15.0), np.degrees(dph)
    assert abs(c_hb[0] - c_dt[0]) < 0.05 * max(amp_dt, 1e-3)
