"""Wind gust via the Field Velocity Method.

Reference: CMeanFlowIteration::SetWind_GustField
(SU2_CFD/src/iteration_structure.cpp:657-850): the prescribed gust is
imposed as the NEGATIVE of the grid velocity (NASA TM-2012-217771, FUN3D
field-velocity gust).  The Split Velocity Method source
(CSourceWindGust, numerics_direct_mean.cpp:4171) exists in the reference
but receives identically ZERO derivatives — every dgust_* line is
commented out (iteration_structure.cpp:780-796) — so the v5 capability
is exactly FVM, replicated here.  Gust shapes: TOP_HAT, SINE,
ONE_M_COSINE, EOG (VORTEX needs the reference's vortex distribution
input file and is not shipped with any case; it raises).

Design: the gust field is an analytic function of (coords, t)
evaluated inside the jitted inner step — the unsteady loop reuses the
rigid-motion ALE machinery with grid_vel = -gust(x, t) as a runtime
argument, so physical steps never retrace."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def gust_velocity(kind: str, coords, t, *, uinf: float, ampl: float,
                  wavelength: float, periods: float, begin_time: float,
                  begin_loc: float, gust_dir: int):
    """(N, 2) gust velocity at physical time t (SetWind_GustField's
    switch, iteration_structure.cpp:766-820)."""
    x = coords[:, 0]
    active_t = t >= begin_time
    x_gust = (x - begin_loc - uinf * (t - begin_time)) / wavelength
    inside = (x_gust > 0.0) & (x_gust < periods) & active_t
    two_pi = 2.0 * np.pi
    if kind == "TOP_HAT":
        mag = jnp.where(inside, ampl, 0.0)
    elif kind == "SINE":
        mag = jnp.where(inside, ampl * jnp.sin(two_pi * x_gust), 0.0)
    elif kind == "ONE_M_COSINE":
        mag = jnp.where(inside,
                        ampl * (1.0 - jnp.cos(two_pi * x_gust)), 0.0)
    elif kind == "EOG":
        mag = jnp.where(
            inside,
            -0.37 * ampl * jnp.sin(3.0 * np.pi * x_gust)
            * (1.0 - jnp.cos(two_pi * x_gust)), 0.0)
    else:
        raise NotImplementedError(
            f"GUST_TYPE= {kind} (VORTEX needs the reference's vortex "
            "distribution input file; NONE disables)")
    gust = jnp.zeros_like(coords)
    return gust.at[:, gust_dir].set(mag)


def run_gust(sim, n_steps: int, n_inner: int = 120,
             quiet: bool = True):
    """Unsteady gust response on the standard implicit path: per physical
    step the grid velocity is set to -gust(x, t) (FVM) and the inner
    pseudo-time transient is converged.  Returns (u, t_guess, history)
    with history rows (t_phys, CL, CD)."""
    import su2_tpu.state as st
    from su2_tpu.ops import timestep
    from su2_tpu.solvers import euler as es

    cfg = sim.cfg
    dt_phys = cfg.unst_timestep
    lib, lay, prm, tparams = sim.lib, sim.lay, sim.params, sim.tparams
    lower, upper = sim.lower, sim.upper
    mesh, bcs = sim.mesh, sim.bcs
    _, _, _, _, vel_inf, _ = sim.freestream_primitives()
    uinf = float(vel_inf[0])
    gd = {"X_DIR": 0, "Y_DIR": 1}[cfg.gust_dir]
    params = dict(uinf=uinf, ampl=cfg.gust_ampl,
                  wavelength=cfg.gust_wavelength,
                  periods=cfg.gust_periods,
                  begin_time=cfg.gust_begin_time,
                  begin_loc=cfg.gust_begin_loc, gust_dir=gd)
    kind = cfg.gust_type

    @jax.jit
    def inner_step(u, t_guess, t_phys):
        gvel = -gust_velocity(kind, mesh.coords, t_phys, **params)
        prm_t = dataclasses.replace(prm, grid_vel=gvel)
        u2, v, _ = st.cons2prim(lib, lay, u, t_guess, tparams)
        dt, _, _ = timestep.local_time_step(mesh, lay, v, prm.cfl,
                                            prm.max_dt, grid_vel=gvel)
        u_new, rms, _, _ = es.implicit_euler_update(
            lib, lay, mesh, prm_t, bcs, u2, v, dt, lower, upper,
            relax=cfg.relaxation_factor_flow,
            linear_solver=cfg.linear_solver,
            linear_iter=cfg.linear_solver_iter,
            linear_tol=cfg.linear_solver_error)
        return u_new, v[:, lay.T], rms

    u, t_guess = sim.u0, sim.t0
    hist = []
    for step_i in range(n_steps):
        t_phys = jnp.asarray((step_i + 1) * dt_phys, dtype=sim.dtype)
        for _ in range(n_inner):
            u, t_guess, rms = inner_step(u, t_guess, t_phys)
        forces = sim.monitor_forces(u, t_guess)
        hist.append((float(t_phys), float(forces["CL"]),
                     float(forces["CD"])))
        if not quiet:
            print(f"gust step {step_i:4d}  CL={hist[-1][1]: .5f}")
    return u, t_guess, np.array(hist)
