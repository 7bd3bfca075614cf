"""Aeroelastic typical-section wing model (2-DOF plunge/pitch).

Reference: CSolver::SetUpTypicalSectionWingModel /
SolveTypicalSectionWingModel (SU2_CFD/src/solver_structure.cpp:1404-1600,
the J.J. Alonso "Fully-Implicit Time-Marching Aeroelastic Solutions" 1994
formulation) + CSurfaceMovement::AeroelasticDeform
(Common/src/grid_movement_structure.cpp:6363) + the flutter-speed-index
freestream override (solver_direct_mean.cpp:3606-3640).

The structural problem is a 2x2 modal system solved on the HOST (it is
four scalars); the aerodynamic coupling runs the existing ALE
machinery: at each physical step the whole mesh moves rigidly by the
accumulated (plunge, pitch) about the elastic axis — rigid motion keeps
the dual volumes exact and the analytic grid velocities satisfy the GCL,
so no elastic mesh smoothing is needed on an O-mesh (design deviation
from the reference's near-surface deformation + volume smoothing; the
physics seen by the flow — the moving no-slip/slip surface — is
identical)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def typical_section_modes(w_h: float, w_a: float, x_a: float,
                          r_a2: float):
    """(Phi (2,2), omega (2,)) of the generalized eigenproblem
    (SetUpTypicalSectionWingModel, solver_structure.cpp:1404-1480):
    M = [[1, x_a], [x_a, r_a^2]], K = diag((w_h/w_a)^2, r_a^2), with Phi
    normalized so Phi^T M Phi = I."""
    r_a = math.sqrt(r_a2)
    w = w_h / w_a
    aux = math.sqrt(r_a ** 2 * w ** 4 - 2 * r_a ** 2 * w ** 2 + r_a ** 2
                    + 4 * x_a ** 2 * w ** 2)
    phi = np.array([
        [(r_a * (r_a - r_a * w ** 2 + aux)) / (2 * x_a * w ** 2),
         (r_a * (r_a - r_a * w ** 2 - aux)) / (2 * x_a * w ** 2)],
        [1.0, 1.0]])
    omega2 = np.array([
        (r_a * (r_a + r_a * w ** 2 - aux)) / (2 * (r_a ** 2 - x_a ** 2)),
        (r_a * (r_a + r_a * w ** 2 + aux)) / (2 * (r_a ** 2 - x_a ** 2))])
    m = np.array([[1.0, x_a], [x_a, r_a2]])
    d = phi.T @ m @ phi
    phi = phi / np.sqrt(np.diag(d))[None, :]
    return phi, np.sqrt(omega2)


@dataclasses.dataclass
class TypicalSection:
    """Host-side 2-DOF structural integrator (2nd-order BDF on each
    decoupled mode, SolveTypicalSectionWingModel:1482-1600).

    State x[j][i]: j = 0 displacement / 1 velocity rows, i = mode."""

    w_h: float
    w_a: float
    x_a: float
    r_a2: float
    vf: float
    b: float = 0.5           # semichord = REYNOLDS_LENGTH / 2

    def __post_init__(self):
        self.phi, self.omega = typical_section_modes(
            self.w_h, self.w_a, self.x_a, self.r_a2)
        self.x_np1 = np.zeros((2, 2))
        self.x_n = np.zeros((2, 2))
        self.x_n1 = np.zeros((2, 2))
        self.pitch = 0.0
        self.plunge = 0.0    # in semichords

    def advance_time(self):
        """Shift the BDF history after a converged physical step
        (SetDualTime_Solver's aeroelastic shuffle)."""
        self.x_n1 = self.x_n.copy()
        self.x_n = self.x_np1.copy()

    def step(self, cl: float, cm: float, dt_phys: float):
        """One structural update from the current aero loads; returns
        (dh, dalpha, h_dot, alpha_dot) — the DELTA displacements since the
        previous call plus absolute rates (displacements[0..3])."""
        dt = dt_phys * self.w_a            # nondimensional structural time
        xi = np.zeros(2)                    # structural damping (ref: 0)
        cons = self.vf ** 2 / math.pi
        f = np.array([cons * (-cl), cons * (2.0 * -cm)])
        f_tilde = self.phi.T @ f

        x_np1_old = self.x_np1.copy()
        x_np1 = np.zeros((2, 2))
        eta = np.zeros(2)
        eta_dot = np.zeros(2)
        for i in range(2):
            w_i = self.omega[i]
            det_a = 9.0 / (4.0 * dt * dt) + 3.0 * w_i * xi[i] / dt \
                + w_i * w_i
            a_inv = np.array([
                [3.0 / (2.0 * dt) + 2.0 * xi[i] * w_i, 1.0],
                [-w_i * w_i, 3.0 / (2.0 * dt)]]) / det_a
            s1 = (-4.0 * self.x_n[0][i] + self.x_n1[0][i]) / (2.0 * dt)
            s2 = (-4.0 * self.x_n[1][i] + self.x_n1[1][i]) / (2.0 * dt)
            rhs = np.array([-s1, f_tilde[i] - s2])
            sol = a_inv @ rhs
            x_np1[:, i] = sol
            eta[i] = sol[0] - x_np1_old[0][i]
            eta_dot[i] = sol[1]
        self.x_np1 = x_np1

        q = self.phi @ eta
        q_dot = self.phi @ eta_dot
        dh = self.b * q[0]
        dalpha = q[1]
        h_dot = self.w_a * self.b * q_dot[0]
        alpha_dot = self.w_a * q_dot[1]
        self.pitch += dalpha
        self.plunge += dh / self.b
        return dh, dalpha, h_dot, alpha_dot


def aeroelastic_freestream_temperature(vf: float, w_alpha: float, b: float,
                                       mu: float, mach: float,
                                       rgas: float = 287.058,
                                       gamma: float = 1.4) -> float:
    """Freestream T from the flutter speed index
    (solver_direct_mean.cpp:3609-3615):
    T gamma R = vf^2 b^2 w_a^2 mu / M^2."""
    tgr = (vf * vf) * (b * b) * (w_alpha * w_alpha) * mu / (mach * mach)
    return tgr / (gamma * rgas)


def run_aeroelastic(sim, n_steps: int, n_inner: int = 200,
                    monitor_tag: str | None = None, quiet: bool = True):
    """Dual-time aeroelastic loop on the inviscid standard path: per
    physical step, converge the inner pseudo-time transient on the mesh
    displaced by the accumulated (plunge, pitch), evaluate (CL, CM) on
    the monitored marker, advance the typical-section model, move the
    mesh.  Returns (u, t_guess, history) with history rows
    (t_phys, plunge_semichords, pitch_rad, cl, cm)."""
    import jax.numpy as jnp

    import su2_tpu.state as st
    from su2_tpu.adjoint import _rebuild_bcs
    from su2_tpu.geometry.diffgeo import build_diffgeo, remesh
    from su2_tpu.solvers import euler as es
    from su2_tpu.ops import timestep
    import jax

    cfg = sim.cfg
    sect = TypicalSection(
        w_h=cfg.plunge_natural_frequency, w_a=cfg.pitch_natural_frequency,
        x_a=cfg.cg_location, r_a2=cfg.radius_gyration_squared,
        vf=cfg.flutter_speed_index, b=cfg.reynolds_length / 2.0)
    dt_phys = cfg.unst_timestep
    tags = tuple(cfg.marker_monitoring) if monitor_tag is None \
        else (monitor_tag,)
    origin = np.array([cfg.motion_origin_x, cfg.motion_origin_y])

    dgeo = build_diffgeo(sim.raw, sim.grid)
    base_mesh = sim.mesh
    coords0 = np.asarray(base_mesh.coords)
    lib, lay, prm, tparams = sim.lib, sim.lay, sim.params, sim.tparams
    lower, upper = sim.lower, sim.upper

    def displaced_coords(plunge_h, pitch_a):
        """Rigid rotation by -pitch about the elastic axis + plunge drop
        (AeroelasticDeform: dh along -y, positive pitch nose-up =
        clockwise rotation, grid_movement_structure.cpp:6400-6440)."""
        c, s = math.cos(pitch_a), math.sin(pitch_a)
        rot = np.array([[c, s], [-s, c]])
        rel = coords0 - origin[None, :]
        out = rel @ rot.T + origin[None, :]
        out[:, 1] -= plunge_h
        return out

    @jax.jit
    def inner_step(u, t_guess, coords, gvel):
        mesh = remesh(base_mesh, dgeo, coords)
        bcs = _rebuild_bcs(sim.bcs, mesh)
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
    h_dot = alpha_dot = 0.0
    for step_i in range(n_steps):
        coords = displaced_coords(sect.plunge * sect.b, sect.pitch)
        coords_j = jnp.asarray(coords, dtype=sim.dtype)
        # rigid-body ALE grid velocity from the (lagged, loose-coupling)
        # structural rates: d/dt [R(-alpha) r0 + origin - h e_y]
        c, s = math.cos(sect.pitch), math.sin(sect.pitch)
        drot = np.array([[-s, c], [-c, -s]])    # dR(-a)/da
        rel = coords0 - origin[None, :]
        gv = alpha_dot * (rel @ drot.T)
        gv[:, 1] -= h_dot
        gvel = jnp.asarray(gv, dtype=sim.dtype)
        for _ in range(n_inner):
            u, t_guess, rms = inner_step(u, t_guess, coords_j, gvel)
        # loads on the displaced mesh (markers rebuilt by remesh)
        mesh_d = remesh(base_mesh, dgeo, coords_j)
        saved_mesh = sim.mesh
        sim.mesh = mesh_d
        try:
            forces = sim.monitor_forces(u, t_guess)
        finally:
            sim.mesh = saved_mesh
        cl, cm = float(forces["CL"]), float(forces.get("CMz", 0.0))
        sect.step(cl, cm, dt_phys)
        sect.advance_time()
        t_phys = (step_i + 1) * dt_phys
        hist.append((t_phys, sect.plunge, sect.pitch, cl, cm))
        if not quiet:
            print(f"aeroelastic step {step_i:4d}: plunge/b="
                  f"{sect.plunge: .5f} pitch={math.degrees(sect.pitch): .4f} deg "
                  f"CL={cl: .4f} CM={cm: .4f}")
    return u, t_guess, np.array(hist)
