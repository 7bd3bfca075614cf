"""Discrete adjoint via JAX reverse-mode AD.

Data-parallel replacement for the reference's CoDiPack-taped discrete adjoint
(SU2's AD datatypes in Common/include/datatypes + the discrete adjoint solver
SU2_CFD/src/solver_adjoint_discrete.cpp and the SU2_DOT projection tool):
instead of taping C++ operations, the pseudo-time fixed point

    u* = G(u*, x)      (one implicit/explicit update of the flow solver)

is differentiated with `jax.vjp`.  The adjoint state solves

    lambda = dJ/du + (dG/du)^T lambda

by reverse fixed-point iteration (exactly SU2's DiscAdj recipe,
driver_structure.cpp discrete-adjoint iteration), and the mesh sensitivity is

    dJ/dx = dJ/dx|_explicit + (dG/dx)^T lambda

with geometry differentiated through geometry/diffgeo.py.

The temperature secant/bisection solve inside cons2prim is a while_loop
(non-reversible); it is re-attached to the tape through its exact analytic
derivative dT/dU (variable_direct_reactive.cpp:786) via a stop-gradient
linearization, so adjoint gradients remain exact.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu import state as st
from su2_tpu.chemistry import library as cl
from su2_tpu.geometry.diffgeo import build_diffgeo, remesh
from su2_tpu.linalg import blockcsr, krylov
from su2_tpu.ops import timestep
from su2_tpu.solvers import euler as es
from su2_tpu.solvers import ns


def linearized_primitives(lib, lay, u, t_star, tparams):
    """Primitive rows V(U) with the T-solve linearized around t_star.

    Value == cons2prim's output at the converged state; the Jacobian w.r.t.
    u is exact because T is re-attached through the analytic dT/dU.
    """
    t0 = jax.lax.stop_gradient(t_star)
    # closed-form primitives at temperature t
    rho = u[:, lay.RHO]
    vel = u[:, lay.RHOVX:lay.RHOVX + lay.ndim] / rho[:, None]
    ys = u[:, lay.RHOS:lay.RHOS + lay.ns] / rho[:, None]

    def prim(t):
        rgas = cl.mixture_rgas(lib, ys)
        p = rho * rgas * t
        h = (u[:, lay.RHOE] + p) / rho
        _, a = cl.frozen_gamma_sound(lib, t, ys)
        return jnp.concatenate([
            t[:, None], vel, p[:, None], rho[:, None], h[:, None], a[:, None],
            ys], axis=1)

    v0 = prim(t0)
    dtdu = jax.lax.stop_gradient(st.dtdu(lib, lay, v0))
    t_lin = t0 + jnp.sum(dtdu * (u - jax.lax.stop_gradient(u)), axis=1)
    # spline-domain guard: far from the linearization point (start-up
    # transients of the adjoint's own pseudo-time map) the extrapolated T
    # can leave the table domain and poison downstream sqrt/log with NaN.
    # Inactive at the converged state (t_lin == t0), so gradients there
    # are untouched.
    t_lin = jnp.clip(t_lin, tparams.tmin, tparams.tmax)
    return prim(t_lin)


def _rebuild_bcs(bcs, mesh):
    return tuple(dc_replace(bc, normal=mesh.markers[bc.tag][1]) for bc in bcs)


def make_fixed_point_step(sim):
    """Differentiable pseudo-time update G(u, coords) of the flow solver.

    Mirrors Simulation._make_implicit_step / _make_explicit_step but with
    (a) metrics re-evaluated from coords and (b) the linearized T-solve.
    Laminar Euler/NS only (frozen-turbulence adjoint is future work).
    """
    lib, lay, prm, tparams = sim.lib, sim.lay, sim.params, sim.tparams
    cfg = sim.cfg
    lower, upper = sim.lower, sim.upper
    dgeo = build_diffgeo(sim.raw, sim.grid)
    base_mesh = sim.mesh
    viscous_mode = cfg.viscous

    def step(u, coords, t_star):
        mesh = remesh(base_mesh, dgeo, coords)
        bcs = _rebuild_bcs(sim.bcs, mesh)
        v = linearized_primitives(lib, lay, u, t_star, tparams)
        if viscous_mode:
            dpdu_full = st.dpdu(lib, lay, v)
            trans0 = ns.viscous.node_transport(lib, lay, v)
            lam_v = ns.viscous_lambda(
                lib, mesh, lay, prm, v, trans0, dpdu_full, None)
            dt, _, _ = timestep.local_time_step(
                mesh, lay, v, prm.cfl, prm.max_dt, lam_visc=lam_v)
            res, wall_mask, _, _, jac = ns.ns_assemble(
                lib, lay, mesh, prm, bcs, v, dt, implicit=True)
            u = ns.enforce_wall_velocity(lay, u, wall_mask)
            dinv = blockcsr.block_jacobi_factor(jac)
            _sel = blockcsr.gather_offdiag(mesh, jac)
            sol, _, _ = krylov.fgmres(
                lambda x: blockcsr.matvec(mesh, jac, x, _sel),
                lambda r: blockcsr.block_jacobi_apply(dinv, r),
                -res, max_iter=cfg.linear_solver_iter,
                tol=cfg.linear_solver_error)
            u_new = jnp.clip(u + cfg.relaxation_factor_flow * sol,
                             lower, upper)
            u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)
        else:
            dt, _, _ = timestep.local_time_step(
                mesh, lay, v, prm.cfl, prm.max_dt)
            u_new, _, _, _ = es.implicit_euler_update(
                lib, lay, mesh, prm, bcs, u, v, dt, lower, upper,
                relax=cfg.relaxation_factor_flow,
                linear_solver=cfg.linear_solver,
                linear_iter=cfg.linear_solver_iter,
                linear_tol=cfg.linear_solver_error)
        return u_new

    return step, dgeo


def make_objective(sim, tags=None, which="CD", include_friction=None):
    """Differentiable force coefficient over marker ``tags``: pressure
    component (Pressure_Forces, solver_direct_mean.cpp:5454; outward =
    -stored) plus, on viscous problems, the friction component
    (Friction_Forces — same tau formula as solvers/forces.py, laminar mu
    at the wall like the reference)."""
    lib, lay, tparams = sim.lib, sim.lay, sim.tparams
    from su2_tpu.ops import viscous as vis

    cfg = sim.cfg
    prm = sim.params
    dgeo = build_diffgeo(sim.raw, sim.grid)
    base_mesh = sim.mesh
    tags = tuple(tags if tags is not None
                 else (cfg.marker_monitoring or base_mesh.markers.keys()))
    _, _, p_inf, rho_inf, vel_inf, _ = sim.freestream_primitives()
    q_dyn = 0.5 * rho_inf * float(vel_inf @ vel_inf) * cfg.ref_area
    comp = {"CD": 0, "CFx": 0, "CL": 1, "CFy": 1}[which]
    if include_friction is None:
        include_friction = bool(cfg.viscous)
    nd = lay.ndim

    def objective(u, coords, t_star):
        mesh = remesh(base_mesh, dgeo, coords)
        v = linearized_primitives(lib, lay, u, t_star, tparams)
        f = 0.0
        if include_friction:
            qg = vis.ns_gradient_vars(lib, lay, v)
            grad = es.compute_gradients(mesh, prm, qg)
            mu = vis.node_transport(lib, lay, v).mu
        for tag in tags:
            nodes, normal = mesh.markers[tag]
            out_n = -normal
            f = f + jnp.sum((v[nodes, lay.P] - p_inf) * out_n[:, comp])
            if include_friction:
                gvel = grad[nodes, 1:1 + nd, :]
                muv = mu[nodes]
                div = jnp.einsum("vdd->v", gvel)
                tau = muv[:, None, None] * (gvel + jnp.swapaxes(gvel, 1, 2)) \
                    - (2.0 / 3.0 * muv * div)[:, None, None] \
                    * jnp.eye(nd, dtype=v.dtype)
                fvec_f = -jnp.einsum("vij,vi->vj", tau, out_n)
                f = f + jnp.sum(fvec_f[:, comp])
        return f / q_dyn

    return objective


def adjoint_sensitivity(sim, u_star, t_star, tags=None, which="CD",
                        n_iter: int = 200, tol: float = 1e-10):
    """Adjoint state + mesh sensitivity at a converged flow state.

    Returns dict with J, lambda, dJ/dx (nP, d) total mesh sensitivity, and
    the adjoint fixed-point residual history.
    """
    step, _ = make_fixed_point_step(sim)
    objective = make_objective(sim, tags, which)
    coords = sim.mesh.coords

    g_of_u = lambda u: step(u, coords, t_star)
    g_of_x = lambda x: step(u_star, x, t_star)
    j_val, vjp_ju = jax.vjp(lambda u: objective(u, coords, t_star), u_star)
    _, vjp_jx = jax.vjp(lambda x: objective(u_star, x, t_star), coords)
    _, vjp_gu = jax.vjp(g_of_u, u_star)
    _, vjp_gx = jax.vjp(g_of_x, coords)

    gj_u = vjp_ju(jnp.asarray(1.0, dtype=u_star.dtype))[0]

    @jax.jit
    def adj_iter(lam):
        return gj_u + vjp_gu(lam)[0]

    lam = gj_u
    hist = []
    for _ in range(n_iter):
        lam_new = adj_iter(lam)
        delta = float(jnp.abs(lam_new - lam).max())
        hist.append(delta)
        lam = lam_new
        if delta < tol:
            break

    sens = vjp_jx(jnp.asarray(1.0, dtype=u_star.dtype))[0] + vjp_gx(lam)[0]
    return {"J": float(j_val), "lambda": lam, "sensitivity": sens,
            "adj_hist": np.asarray(hist)}


def make_rans_fixed_point_step(sim, cfl_scale: float = 1.0):
    """Differentiable coupled REACTIVE_RANS update G((u, q), x).

    The turbulent discrete adjoint differentiates through BOTH systems —
    the flow update (with the SST closures, eddy viscosity and blended
    sigma_k all expressed as functions of q) and the SST update on the
    updated flow state — mirroring the reference's CoDiPack tape over the
    full coupled iteration (solver_adjoint_discrete.cpp + the REACTIVE_RANS
    sequencing of iteration_structure.cpp:531-550).  No frozen-mu_t
    approximation.
    """
    from su2_tpu.ops import viscous as vis
    from su2_tpu.turbulence import sst

    lib, lay, prm, tparams = sim.lib, sim.lay, sim.params, sim.tparams
    cfg, scfg = sim.cfg, sim.scfg
    lower, upper = sim.lower, sim.upper
    dgeo = build_diffgeo(sim.raw, sim.grid)
    base_mesh = sim.mesh
    dist = sim.wall_dist
    color_masks = sim.color_masks
    assert cfg.kind_turb_model == "SST", "coupled adjoint: SST only"

    def turb_grads(mesh, q):
        if scfg.grad_method == "GREEN_GAUSS":
            from su2_tpu.ops import gradients
            return gradients.pg_fix(mesh, gradients.green_gauss(mesh, q))
        from su2_tpu.ops import gradients
        return gradients.pg_fix(mesh, gradients.weighted_least_squares(mesh, q))

    def step(u, q, coords, t_star):
        mesh = remesh(base_mesh, dgeo, coords)
        bcs = _rebuild_bcs(sim.bcs, mesh)
        v = linearized_primitives(lib, lay, u, t_star, tparams)
        rho = v[:, lay.PRHO]
        dpdu_full = st.dpdu(lib, lay, v)
        trans0 = ns.viscous.node_transport(lib, lay, v)
        qgrad = vis.ns_gradient_vars(lib, lay, v)
        grad = es.compute_gradients(mesh, prm, qgrad)
        gq = turb_grads(mesh, q)
        strain, _ = sst.strain_and_vorticity(lay, grad)
        f1, f2, _ = sst.blending(q[:, 0], q[:, 1], gq[:, 0, :], gq[:, 1, :],
                                 trans0.mu, rho, dist)
        mu_t = sst.eddy_viscosity(rho, q[:, 0], q[:, 1], strain, f2)
        sigma_k = f1 * sst.SIGMA_K1 + (1.0 - f1) * sst.SIGMA_K2
        turb = vis.TurbFlowData(tke=q[:, 0], mu_t=mu_t,
                                grad_tke=gq[:, 0, :], sigma_k=sigma_k)
        lam_v = ns.viscous_lambda(lib, mesh, lay, prm, v, trans0,
                                  dpdu_full, turb)
        # cfl_scale shrinks the pseudo-time step to keep the
        # block-Jacobi-preconditioned map contractive; the fixed point
        # (R(u*) = 0) is CFL-independent, so adjoint gradients are not
        dt, _, _ = timestep.local_time_step(mesh, lay, v,
                                            prm.cfl * cfl_scale,
                                            prm.max_dt, lam_visc=lam_v)
        sigma_k_edge = sigma_k[mesh.edges[:, 0]]
        if cfg.implicit_flow:
            res, wall_mask, _, _, jac, flow_fb = ns.ns_assemble(
                lib, lay, mesh, prm, bcs, v, dt, implicit=True, turb=turb,
                omega_turb=q[:, 1], sigma_k_edge=sigma_k_edge,
                want_bc_states=True)
            u2 = ns.enforce_wall_velocity(lay, u, wall_mask)
            # same preconditioner class as the production solver
            mv, pc = blockcsr.make_solver_ops(
                mesh, jac, cfg.linear_solver_prec, color_masks)
            sol, _, _ = krylov.fgmres(
                mv, pc, -res, max_iter=cfg.linear_solver_iter,
                tol=cfg.linear_solver_error)
            u_new = jnp.clip(u2 + cfg.relaxation_factor_flow * sol,
                             lower, upper)
        else:
            res, wall_mask, _, _, flow_fb = ns.ns_assemble(
                lib, lay, mesh, prm, bcs, v, turb=turb, omega_turb=q[:, 1],
                sigma_k_edge=sigma_k_edge, want_bc_states=True)
            u2 = ns.enforce_wall_velocity(lay, u, wall_mask)
            u_new, _, _ = es.explicit_euler_update(
                lay, mesh, u2, res, dt, lower, upper)
        u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)

        # ---- SST system on the updated flow state ----
        v_new = linearized_primitives(lib, lay, u_new, t_star, tparams)
        qgrad2 = vis.ns_gradient_vars(lib, lay, v_new)
        grad_new = es.compute_gradients(mesh, prm, qgrad2)
        strain2, _ = sst.strain_and_vorticity(lay, grad_new)
        mu_new = ns.viscous.node_transport(lib, lay, v_new).mu
        gm1 = st.dpdu(lib, lay, v_new)[:, lay.RHOE]
        q_new, _, _ = sst.sst_step(
            lay, mesh, scfg, bcs, q, v_new, grad_new, mu_new, mu_t,
            strain2, dist, rho, dt, sim.kine_inf, sim.omega_inf,
            lib=lib, dpdu_e=gm1, tke_inf=prm.tke_inf, flow_fb=flow_fb)
        return u_new, q_new

    return step, dgeo


def adjoint_sensitivity_rans(sim, u_star, q_star, t_star, tags=None,
                             which="CD", n_iter: int = 400,
                             tol: float = 1e-12, method: str = "gmres",
                             cfl_scale: float | None = None,
                             restart: int = 60):
    """Coupled turbulent adjoint: stacked (lambda_u, lambda_q) solve of

        (I - dG^T) lambda = dJ/du

    over the full RANS step; objective includes the friction component
    (make_objective).  Returns J, the adjoint pair, dJ/dx, and a
    ``converged`` flag.

    Conditioning (round-4 spectral analysis, scripts/diag_adjoint2.py):
    at the production CFL the update map G keeps every slow physical mode
    near-neutral — dense eigendecomposition on the channel case found 32
    eigenvalues of dG within 1e-2 of 1.0 (min |1-eig| = 7e-7), because
    the pseudo-time Vol/dt diagonal dominates the implicit solve:
    eig(dG) ~ (Vol/dt)/(Vol/dt + a) -> 1 for slow modes a.  Both the
    reference's Picard recipe (solver_adjoint_discrete.cpp's reverse
    fixed point) and restarted GMRES stall on that cluster.  The fix is
    CFL-scaling the ADJOINT map: the fixed point (R = 0) is
    dt-independent, so G built with cfl_scale >> 1 has the same fixed
    point but dG ~ I - P A -> 0 wherever the inner FGMRES resolves A —
    the transposed system becomes well-conditioned and GMRES converges
    in a few restarts.  cfl_scale defaults to 1e6 for method="gmres"
    (1.0 for the reference-recipe method="picard", kept for
    comparison/attribution).

    `n_iter` bounds the total matvec count for both methods (each matvec
    is one coupled-step VJP; gmres passes run `restart` matvecs each,
    maxiter=1 so the documented budget holds).  adj_hist records
    linear-system residuals (for Picard the update delta IS the residual
    b - A lam)."""
    if cfl_scale is None:
        cfl_scale = 1e6 if method == "gmres" else 1.0
    step, _ = make_rans_fixed_point_step(sim, cfl_scale=cfl_scale)
    objective = make_objective(sim, tags, which)
    coords = sim.mesh.coords

    j_val, vjp_ju = jax.vjp(lambda u: objective(u, coords, t_star), u_star)
    _, vjp_jx = jax.vjp(lambda x: objective(u_star, x, t_star), coords)
    _, vjp_g = jax.vjp(lambda u, q: step(u, q, coords, t_star),
                       u_star, q_star)
    _, vjp_gx = jax.vjp(lambda x: step(u_star, q_star, x, t_star), coords)

    gj_u = vjp_ju(jnp.asarray(1.0, dtype=u_star.dtype))[0]
    zero_q = jnp.zeros_like(q_star)

    hist = []
    converged = False
    if method == "gmres":
        from jax.scipy.sparse import linalg as spla

        @jax.jit
        def matvec(lam):
            du, dq = vjp_g(lam)
            return (lam[0] - du, lam[1] - dq)

        b = (gj_u, zero_q)
        bnorm = float(max(jnp.abs(b[0]).max(), 1e-300))
        lam = b
        for _ in range(max(1, n_iter // restart)):
            r = matvec(lam)
            res = float(max(jnp.abs(b[0] - r[0]).max(),
                            jnp.abs(b[1] - r[1]).max()))
            hist.append(res)
            # converged: absolute tol, or an 8-order drop from the
            # initial linear residual / RHS scale
            if res < max(tol, 1e-8 * max(hist[0], bnorm)):
                converged = True
                break
            if len(hist) > 3 and res > 0.99 * hist[-2]:
                break
            # maxiter=1: each pass builds exactly ONE restart-sized
            # Krylov space (restart matvecs), keeping the n_iter matvec
            # budget honest (jax gmres maxiter counts restart cycles)
            lam, _ = spla.gmres(matvec, b, x0=lam, restart=restart,
                                maxiter=1, tol=1e-30, atol=0.0)
        lam_u, lam_q = lam
    else:
        @jax.jit
        def adj_iter(lam_u, lam_q):
            du, dq = vjp_g((lam_u, lam_q))
            return gj_u + du, dq

        lam_u, lam_q = gj_u, zero_q
        for _ in range(n_iter):
            lu_new, lq_new = adj_iter(lam_u, lam_q)
            delta = float(jnp.abs(lu_new - lam_u).max())
            hist.append(delta)
            lam_u, lam_q = lu_new, lq_new
            if delta < tol:
                converged = True
                break

    if not converged:
        import warnings
        warnings.warn(
            f"coupled adjoint ({method}) exited UNCONVERGED: residual "
            f"{hist[-1]:.3e} after {len(hist)} checks — dJ/dx may be "
            "inaccurate (inspect adj_hist)")
    sens = vjp_jx(jnp.asarray(1.0, dtype=u_star.dtype))[0] \
        + vjp_gx((lam_u, lam_q))[0]
    return {"J": float(j_val), "lambda": lam_u, "lambda_turb": lam_q,
            "sensitivity": sens, "adj_hist": np.asarray(hist),
            "converged": converged}
