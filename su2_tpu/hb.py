"""Harmonic-balance (time-spectral) driver.

Reference capability: CHBDriver (SU2_CFD/src/driver_structure.cpp:3790
CHBDriver::Run, :3928 SetHarmonicBalance, :4087 ComputeHB_Operator): the
periodic unsteady problem is replaced by N coupled steady problems at the
time instances t_i = i T / N, linked by the pseudo-spectral time-derivative
operator

    D = Re( V  diag(j Omega_k)  V^{-1} ),   V[i, k] = exp(j Omega_k t_i)

and each instance solves  R(u_i) + Vol * sum_j D_ij u_j = 0.

Design: the reference runs N separate zone containers in a host
loop; here the instances are a BATCH AXIS — one stacked state
u (N, nP, nvar), the per-instance residual vmapped over the axis, and the
spectral coupling a single einsum.  For moving-grid problems each instance
carries its own coordinates/grid velocities (rigid motion at phase t_i)
through the differentiable remesh, inside the same jit."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def hb_operator(period: float, omegas, n_inst: int) -> np.ndarray:
    """The reference's HB operator (ComputeHB_Operator,
    driver_structure.cpp:4087): D = Re(V diag(j w) V^-1) with
    V[i,k] = exp(j w_k t_i), t_i = i*period/n."""
    omegas = np.asarray(omegas, dtype=float)
    assert omegas.shape == (n_inst,)
    t = np.arange(n_inst) * period / n_inst
    v = np.exp(1j * np.outer(t, omegas))           # (N, N)
    d = v @ np.diag(1j * omegas) @ np.linalg.inv(v)
    return np.real(d)


def default_omegas(period: float, n_inst: int) -> np.ndarray:
    """Symmetric harmonic set (0, +-w0, +-2w0, ...) like the reference's
    OMEGA_HB examples; n_inst must be odd for a symmetric set."""
    w0 = 2.0 * np.pi / period
    k = np.concatenate([[0.0], np.repeat(np.arange(1, (n_inst + 1) // 2), 2)
                        * np.tile([1.0, -1.0], (n_inst - 1) // 2)[:n_inst - 1]])
    return w0 * k[:n_inst]


class HBDriver:
    """N-instance harmonic balance, with optional rigid motion (each
    instance frozen at its phase).

    Covers the reference CHBDriver's solver surface
    (driver_structure.cpp:3790-3987): explicit Euler (round-3 path) AND —
    round 4 — implicit pseudo-time on the viscous/turbulent standard
    iterate: per instance one implicit NS/RANS update with the spectral
    source Vol * sum_j D_ij U_j added to the flow residual and (for SST)
    Vol * sum_j D_ij (rho k, rho w)_j to the turbulence residual — the
    reference's explicit-source semantics (no Jacobian contribution,
    solver_direct_mean.cpp:5187, solver_direct_turbulent.cpp:1590).
    Instances ride a vmapped batch axis.

    sim: a Simulation configured for the case (and, if moving,
    GRID_MOVEMENT_KIND= RIGID_MOTION).  period/omegas: HB_PERIOD and
    OMEGA_HB (defaults to the symmetric harmonic set)."""

    def __init__(self, sim, n_inst: int, period: float, omegas=None):
        import dataclasses as _dc

        from su2_tpu import motion as mo
        from su2_tpu.adjoint import _rebuild_bcs
        from su2_tpu.geometry.diffgeo import build_diffgeo, remesh
        import su2_tpu.state as st
        from su2_tpu.solvers import euler as es
        from su2_tpu.ops import timestep

        self.sim = sim
        self.n_inst = n_inst
        self.period = period
        om = np.asarray(omegas) if omegas is not None \
            else default_omegas(period, n_inst)
        self.d_op = jnp.asarray(hb_operator(period, om, n_inst),
                                dtype=sim.dtype)
        self.times = np.arange(n_inst) * period / n_inst

        lib, lay, prm, tparams = sim.lib, sim.lay, sim.params, sim.tparams
        lower, upper = sim.lower, sim.upper
        base_mesh = sim.mesh
        coords0 = base_mesh.coords
        moving = sim.motion is not None
        if moving:
            assert sim.motion.kind == "RIGID_MOTION"
            coords_i = jnp.stack([
                mo.rigid_coords_2d(sim.motion, coords0, t).astype(sim.dtype)
                for t in self.times])
            gvel_i = jnp.stack([
                mo.rigid_grid_velocity_2d(sim.motion, c, t).astype(sim.dtype)
                for c, t in zip(coords_i, self.times)])
            dgeo = build_diffgeo(sim.raw, sim.grid)
        else:
            coords_i = jnp.stack([coords0] * n_inst)
            gvel_i = None
            dgeo = build_diffgeo(sim.raw, sim.grid)
        vol0 = base_mesh.volume

        self.implicit = bool(sim.cfg.implicit_flow)
        self.turbulent = bool(getattr(sim, "turbulent", False))
        if self.implicit:
            self._build_implicit_step(sim, coords_i, gvel_i, dgeo,
                                      base_mesh)
            return

        def one_residual(u, t_guess, coords, gvel):
            mesh = _dc.replace(
                remesh(base_mesh, dgeo, coords),
                gg_snormal=None, wls_coeff=None, stencil_pvec=None,
                fam_normal=None, fam_evec=None, fam_offsets=None)
            bcs = _rebuild_bcs(sim.bcs, mesh)
            prm_t = _dc.replace(prm, grid_vel=gvel)
            u2, v, _ = st.cons2prim(lib, lay, u, t_guess, tparams)
            res, _ = es.total_residual(lib, lay, mesh, prm_t, bcs, v)
            dt, _, _ = timestep.local_time_step(
                mesh, lay, v, prm.cfl, prm.max_dt, grid_vel=gvel)
            return u2, v[:, lay.T], res, dt, mesh.volume

        @jax.jit
        def step(u_all, t_all):
            if gvel_i is None:
                u2, tg, res, dt, vol = jax.vmap(
                    lambda u, t, c: one_residual(u, t, c, None))(
                        u_all, t_all, coords_i)
            else:
                u2, tg, res, dt, vol = jax.vmap(one_residual)(
                    u_all, t_all, coords_i, gvel_i)
            # spectral time-derivative source (SetHarmonicBalance):
            # R_i += Vol * sum_j D_ij u_j
            hb_src = jnp.einsum("ij,jnv->inv", self.d_op, u2) \
                * vol[:, :, None]
            res = res + hb_src
            u_new = jax.vmap(
                lambda u, r, d: es.explicit_euler_update(
                    lay, base_mesh, u, r, d, lower, upper)[0])(u2, res, dt)
            rms = jnp.sqrt(jnp.mean(res * res, axis=(0, 1)))
            return u_new, tg, rms

        self._step = step

    def _build_implicit_step(self, sim, coords_i, gvel_i, dgeo, base_mesh):
        """Implicit pseudo-time HB on the (inviscid / NS / SST-RANS)
        iterate: one vmapped implicit update per instance with the
        spectral sources added explicitly to the residuals."""
        import dataclasses as _dc

        from su2_tpu import state as st
        from su2_tpu.adjoint import _rebuild_bcs
        from su2_tpu.geometry.diffgeo import remesh
        from su2_tpu.linalg import blockcsr, krylov
        from su2_tpu.ops import timestep
        from su2_tpu.ops import viscous as vis
        from su2_tpu.solvers import euler as es
        from su2_tpu.solvers import ns

        sim_ = sim
        lib, lay, prm, tparams = sim.lib, sim.lay, sim.params, sim.tparams
        cfg = sim.cfg
        lower, upper = sim.lower, sim.upper
        viscous = bool(cfg.viscous)
        turb_on = self.turbulent
        d_op = self.d_op
        dist = sim.__dict__.get("wall_dist")
        scfg = None
        if turb_on:
            from su2_tpu.turbulence import sst
            assert cfg.kind_turb_model == "SST", "HB turbulence: SST only"
            scfg = _dc.replace(sim.scfg, color_masks=None)

        def strip(mesh):
            # instance meshes drop the static-stencil fast paths: the
            # edge layouts vmap over instances
            return _dc.replace(
                mesh, gg_snormal=None, wls_coeff=None, stencil_pvec=None,
                fam_normal=None, fam_evec=None, fam_offsets=None,
                stencil_sel=None, stencil_offsets=None)

        # HB pseudo-time preconditioning: the spectral source is explicit
        # (reference semantics), so the instance-coupling mode grows ~
        # sqrt(1 + (w dt)^2) per pseudo-step; scaling dt <- dt/(1+w_max dt)
        # bounds w dt_eff < 1 (the later SU2 HB stabilization; the v5
        # reference relies on the user lowering CFL instead)
        w_max = float(np.abs(self.d_op).sum(axis=1).max())

        def hb_dt(dt):
            return dt / (1.0 + w_max * dt)

        def one(u, q, t_guess, hb_u, hb_q, coords, gvel):
            mesh = strip(remesh(base_mesh, dgeo, coords))
            bcs = _rebuild_bcs(sim_.bcs, mesh)
            prm_t = _dc.replace(prm, grid_vel=gvel)
            u2, v, _ = st.cons2prim(lib, lay, u, t_guess, tparams)
            if not viscous:
                dt, _, _ = timestep.local_time_step(
                    mesh, lay, v, prm.cfl, prm.max_dt, grid_vel=gvel)
                dt = hb_dt(dt)
                u_new, rms, _, _ = es.implicit_euler_update(
                    lib, lay, mesh, prm_t, bcs, u2, v, dt, lower, upper,
                    relax=cfg.relaxation_factor_flow,
                    linear_solver=cfg.linear_solver,
                    linear_iter=cfg.linear_solver_iter,
                    linear_tol=cfg.linear_solver_error,
                    hb_src=hb_u)
                return u_new, q, v[:, lay.T], rms

            rho = v[:, lay.PRHO]
            dpdu_full = st.dpdu(lib, lay, v)
            trans0 = ns.viscous.node_transport(lib, lay, v)
            turb = None
            omega_turb = None
            sigma_k_edge = None
            if turb_on:
                from su2_tpu.ops import gradients
                from su2_tpu.turbulence import sst
                qgrad = vis.ns_gradient_vars(lib, lay, v)
                grad = es.compute_gradients(mesh, prm_t, qgrad)
                if scfg.grad_method == "GREEN_GAUSS":
                    gq = gradients.pg_fix(mesh, gradients.green_gauss(
                        mesh, q))
                else:
                    gq = gradients.pg_fix(
                        mesh, gradients.weighted_least_squares(mesh, q))
                strain, _ = sst.strain_and_vorticity(lay, grad)
                f1, f2, _ = sst.blending(q[:, 0], q[:, 1], gq[:, 0, :],
                                         gq[:, 1, :], trans0.mu, rho, dist)
                mu_t = sst.eddy_viscosity(rho, q[:, 0], q[:, 1], strain,
                                          f2)
                sigma_k = f1 * sst.SIGMA_K1 + (1.0 - f1) * sst.SIGMA_K2
                turb = vis.TurbFlowData(tke=q[:, 0], mu_t=mu_t,
                                        grad_tke=gq[:, 0, :],
                                        sigma_k=sigma_k)
                omega_turb = q[:, 1]
                sigma_k_edge = sigma_k[mesh.edges[:, 0]]
            lam_v = ns.viscous_lambda(lib, mesh, lay, prm_t, v, trans0,
                                      dpdu_full, turb)
            dt, _, _ = timestep.local_time_step(
                mesh, lay, v, prm.cfl, prm.max_dt, lam_visc=lam_v,
                grid_vel=gvel)
            dt = hb_dt(dt)
            res, wall_mask, _, _, jac, flow_fb = ns.ns_assemble(
                lib, lay, mesh, prm_t, bcs, v, dt, implicit=True,
                turb=turb, omega_turb=omega_turb,
                sigma_k_edge=sigma_k_edge, want_bc_states=True)
            res = res + hb_u * mesh.volume[:, None]
            u2w = ns.enforce_wall_velocity(lay, u2, wall_mask)
            mv, pc = blockcsr.make_solver_ops(
                mesh, jac, cfg.linear_solver_prec, sim_.color_masks)
            sol, _, _ = krylov.fgmres(
                mv, pc, -res, max_iter=cfg.linear_solver_iter,
                tol=cfg.linear_solver_error)
            u_new = jnp.clip(u2w + cfg.relaxation_factor_flow * sol,
                             lower, upper)
            u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)
            rms = jnp.sqrt(jnp.mean(res * res, axis=0))
            if not turb_on:
                return u_new, q, v[:, lay.T], rms

            from su2_tpu.turbulence import sst
            _, v_new, _ = st.cons2prim(lib, lay, u_new, v[:, lay.T],
                                       tparams)
            qgrad2 = vis.ns_gradient_vars(lib, lay, v_new)
            grad_new = es.compute_gradients(mesh, prm_t, qgrad2)
            strain2, _ = sst.strain_and_vorticity(lay, grad_new)
            mu_new = ns.viscous.node_transport(lib, lay, v_new).mu
            gm1 = st.dpdu(lib, lay, v_new)[:, lay.RHOE]
            q_new, _, _ = sst.sst_step(
                lay, mesh, scfg, bcs, q, v_new, grad_new, mu_new, mu_t,
                strain2, dist, rho, dt, sim_.kine_inf, sim_.omega_inf,
                lib=lib, dpdu_e=gm1, tke_inf=prm.tke_inf,
                flow_fb=flow_fb, hb_src=hb_q)
            return u_new, q_new, v_new[:, lay.T], rms

        coords_b = coords_i
        gvel_b = gvel_i

        @jax.jit
        def step(u_all, q_all, t_all):
            # spectral sources (SetHarmonicBalance): flow on conserved U,
            # turbulence on conserved (rho k, rho w)
            hb_u = jnp.einsum("ij,jnv->inv", d_op, u_all)
            if turb_on:
                # rho per instance from the conserved state
                rho_all = u_all[:, :, lay.RHO]
                hb_q = jnp.einsum("ij,jnv->inv", d_op,
                                  rho_all[:, :, None] * q_all)
            else:
                hb_q = jnp.zeros_like(q_all)
            if gvel_b is None:
                un, qn, tn, rms = jax.vmap(
                    lambda u, q, t, su, sq, c: one(u, q, t, su, sq, c,
                                                   None))(
                    u_all, q_all, t_all, hb_u, hb_q, coords_b)
            else:
                un, qn, tn, rms = jax.vmap(one)(
                    u_all, q_all, t_all, hb_u, hb_q, coords_b, gvel_b)
            return un, qn, tn, jnp.sqrt(jnp.mean(rms * rms, axis=0))

        self._step_implicit = step

    def run(self, n_iter: int, quiet: bool = True):
        n = self.n_inst
        u_all = jnp.stack([self.sim.u0] * n)
        t_all = jnp.stack([self.sim.t0] * n)
        if self.implicit:
            if self.turbulent:
                q0 = self.sim.initial_turb_state()[0]
            else:
                q0 = jnp.zeros((self.sim.u0.shape[0], 2),
                               dtype=self.sim.dtype)
            q_all = jnp.stack([q0] * n)
            hist = []
            for it in range(n_iter):
                u_all, q_all, t_all, rms = self._step_implicit(
                    u_all, q_all, t_all)
                if it % 50 == 0 or it == n_iter - 1:
                    lr = np.log10(np.maximum(np.asarray(rms, np.float64), 1e-300))
                    hist.append(lr)
                    if not quiet:
                        print(f"HB iter {it:5d}  Res[Rho]: "
                              f"{lr[self.sim.lay.RHO]: .4f}")
            self.q_all = q_all
            return u_all, t_all, np.array(hist)
        hist = []
        for it in range(n_iter):
            u_all, t_all, rms = self._step(u_all, t_all)
            if it % 50 == 0 or it == n_iter - 1:
                lr = np.log10(np.maximum(np.asarray(rms, np.float64), 1e-300))
                hist.append(lr)
                if not quiet:
                    print(f"HB iter {it:5d}  Res[Rho]: "
                          f"{lr[self.sim.lay.RHO]: .4f}")
        return u_all, t_all, np.array(hist)
